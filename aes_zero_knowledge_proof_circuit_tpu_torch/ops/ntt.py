"""Radix-2 NTT over Fr limb tensors — counterpart of ops/ntt_jax.py.

Decimation in time over [n, 8] Montgomery limbs, run in passes of at most
PASS_LOG consecutive stages: one launch of kernel K2 (csrc/ntt.cu) a pass on
CUDA tensors, the plain PyTorch pass below on CPU tensors. A pass over
stages t0 .. t0 + s - 1 works on n / 2^s independent tiles of 2^s elements
spaced 2^t0 apart (`pass_widths` splits log2 n evenly: two passes from 2^11
to 2^20). The first pass reads its input in bit-reversed order; the last
multiplies by 1/n in the inverse transform. Every stage's twiddles are
strided reads of ONE [n/2, 8] table of omega powers, built once per size on
the tensor's device and finished before it is cached, so that every stream
may read it (`field.table_built`). `ntt_rows` / `intt_rows` transform a
batch [B, n, 8] of independent rows in the same launches (the four-step
NTT's passes, parallel/sharded_ntt.py).
"""

from __future__ import annotations

import functools
from typing import List

import torch

from .field_params import (
    R_MOD,
    root_of_unity,
)

from .. import kernels
from ..utils import spans
from .field import aligned, fr_ops, table_built

F = fr_ops()
PASS_LOG = 10          # stages a pass: tiles of 2^10 elements, 32 KB
MAX_BATCH = 65535      # rows one K2 launch takes (gridDim.y, csrc/ntt.cu)


def pass_widths(log_n: int, pass_log: int = PASS_LOG) -> List[int]:
    """Stages of each pass: ceil(log_n / pass_log) passes, as even as
    possible, the wider ones first."""
    passes = max(1, -(-log_n // pass_log))
    base, extra = divmod(log_n, passes)
    return [base + 1] * extra + [base] * (passes - extra)


@functools.lru_cache(maxsize=None)
def _bitrev(log_n: int, device: str) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    rev = rev.to(device)
    table_built(device)
    return rev


def plain_pass(src: torch.Tensor, table: torch.Tensor, log_n: int, t0: int,
               s: int, bitrev: bool, scale=None) -> torch.Tensor:
    """One pass in plain PyTorch, the same function as K2's: stages t0 ..
    t0 + s - 1 on tiles [hi, mid, lo] = [n / 2^(t0+s), 2^s, 2^t0] of the
    input (read in bit-reversed order if `bitrev`), then the scale. The
    input is [n, 8] or a batch [B, n, 8] of independent rows."""
    n = 1 << log_n
    x = src[..., _bitrev(log_n, str(src.device)), :] if bitrev else \
        src.clone()
    lead = x.shape[:-2]
    tiles = x.view(*lead, n >> (t0 + s), 1 << s, 1 << t0, F.L)
    lo = torch.arange(1 << t0, device=x.device)
    for u in range(s):
        h = 1 << u
        # stage t0 + u: offset j = (mid mod 2^u) 2^t0 + lo in its group,
        # twiddle omega^(j n / 2^(t0+u+1)), table row j (n >> (t0+u+1))
        j = (torch.arange(h, device=x.device)[:, None] << t0) | lo[None, :]
        tw = table[j * (n >> (t0 + u + 1))]              # [h, 2^t0, 8]
        g = tiles.view(*lead, n >> (t0 + s), (1 << s) // (2 * h), 2, h,
                       1 << t0, F.L)
        left = g.select(-4, 0).clone()
        prod = F.plain_mul(g.select(-4, 1), tw)
        g.select(-4, 0).copy_(F.plain_add(left, prod))
        g.select(-4, 1).copy_(F.plain_sub(left, prod))
    if scale is not None:
        x = F.plain_mul(x, scale)
    return x


def ntt_pass(src: torch.Tensor, dst: torch.Tensor, table: torch.Tensor,
             log_n: int, t0: int, s: int, bitrev: bool, scale=None) -> None:
    """K2 wrapper: one pass from src into dst ([n, 8], or [B, n, 8] with B
    at most MAX_BATCH, int32 on the current card, 16-byte aligned; src is
    dst after the first pass): one launch."""
    kernels.check_device(src, dst, table,
                         *(() if scale is None else (scale,)))
    kernels.ntt_pass(src.data_ptr(), dst.data_ptr(), table.data_ptr(),
                     None if scale is None else scale.data_ptr(), log_n, t0,
                     s, int(bitrev), src.numel() >> (log_n + 3))


class NTTEngine:
    """Forward and inverse NTT of one size on one device."""

    def __init__(self, log_n: int, device, pass_log: int = PASS_LOG):
        from .poly import powers, scalar

        self.log_n = log_n
        self.n = 1 << log_n
        self.device = torch.device(device)
        self.widths = pass_widths(log_n, pass_log)
        omega = root_of_unity(log_n) if log_n else 1
        half = max(1, self.n // 2)
        self.fwd_table = powers(scalar(omega, self.device), half)
        self.inv_table = powers(scalar(pow(omega, -1, R_MOD), self.device),
                                half)
        self.n_inv = scalar(pow(self.n, -1, R_MOD), self.device)
        table_built(self.device)

    def _check(self, x: torch.Tensor, rows: bool = False) -> None:
        dims = 3 if rows else 2
        if x.dtype != torch.int32 or x.dim() != dims or x.shape[-1] != F.L:
            shape = "[B, n, 8]" if rows else "[n, 8]"
            raise ValueError(f"expected {shape} int32, got {tuple(x.shape)}")
        if x.shape[-2] != self.n:
            raise ValueError(f"NTT of size {self.n} given {x.shape[-2]} rows")
        if rows and x.shape[0] > MAX_BATCH:
            raise ValueError(f"{x.shape[0]} rows exceed K2's {MAX_BATCH}")

    def _passes(self):
        """(t0, s, first, last) of each pass."""
        t0 = 0
        for i, s in enumerate(self.widths):
            yield t0, s, i == 0, i == len(self.widths) - 1
            t0 += s

    def _run(self, x: torch.Tensor, table: torch.Tensor, scale,
             rows: bool = False) -> torch.Tensor:
        if x.device.type == "cpu":
            return self._run_plain(x, table, scale, rows)
        self._check(x, rows)
        if x.device.type != "cuda" or table.device != x.device:
            raise ValueError(f"no kernel for {x.device} / table on "
                             f"{table.device}")
        if self.log_n == 0:
            return x.clone()
        x = aligned(x)
        out = torch.empty_like(x)
        for t0, s, first, last in self._passes():
            ntt_pass(x if first else out, out, table, self.log_n, t0, s,
                     first, scale if last else None)
        return out

    def _run_plain(self, x, table, scale, rows: bool = False) -> torch.Tensor:
        self._check(x, rows)
        if self.log_n == 0:
            return x.clone()
        for t0, s, first, last in self._passes():
            x = plain_pass(x, table, self.log_n, t0, s, first,
                           scale if last else None)
        return x

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[n, 8] coefficients -> evaluations on <omega> (natural order)."""
        with spans.span("ntt", n=self.n, rows=1):
            return self._run(coeffs, self.fwd_table, None)

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        with spans.span("ntt", n=self.n, rows=1):
            return self._run(evals, self.inv_table, self.n_inv)

    def ntt_rows(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[B, n, 8]: the NTT of every row, in the launches of one NTT."""
        with spans.span("ntt", n=self.n, rows=coeffs.shape[0]):
            return self._run(coeffs, self.fwd_table, None, rows=True)

    def intt_rows(self, evals: torch.Tensor) -> torch.Tensor:
        with spans.span("ntt", n=self.n, rows=evals.shape[0]):
            return self._run(evals, self.inv_table, self.n_inv, rows=True)

    def ntt_plain(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The same transform through the plain passes (any device)."""
        return self._run_plain(coeffs, self.fwd_table, None)

    def intt_plain(self, evals: torch.Tensor) -> torch.Tensor:
        return self._run_plain(evals, self.inv_table, self.n_inv)

    def ntt_rows_plain(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self._run_plain(coeffs, self.fwd_table, None, rows=True)

    def intt_rows_plain(self, evals: torch.Tensor) -> torch.Tensor:
        return self._run_plain(evals, self.inv_table, self.n_inv, rows=True)


@functools.lru_cache(maxsize=None)
def _engine(log_n: int, device: str) -> NTTEngine:
    return NTTEngine(log_n, device)


def ntt_engine(log_n: int, device) -> NTTEngine:
    return _engine(log_n, str(torch.device(device)))
