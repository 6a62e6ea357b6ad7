"""Radix-2 NTT over Fr limb tensors — counterpart of ops/ntt_jax.py.

Decimation in time over [n, 8] Montgomery limbs: a bit-reversal gather,
then log2(n) butterfly stages, each one launch of kernel K2
(csrc/ntt.cu) on CUDA tensors or the plain PyTorch stage below on CPU
tensors. Every stage's twiddles are strided reads of ONE [n/2, 8] table of
omega powers, built once per size on the tensor's device. The inverse
transform runs the same stages on the inverse table and scales by 1/n
with kernel K1.
"""

from __future__ import annotations

import functools

import torch

from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import (
    R_MOD,
    root_of_unity,
)

from .. import kernels
from .field import fr_ops

F = fr_ops()


def bitrev_perm(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.to(device)


def plain_stage(x: torch.Tensor, table: torch.Tensor, half: int) -> None:
    """One DIT stage in place: (l + r*w, l - r*w) over groups of 2*half,
    w = table[j * n / (2 half)]. Same function as K2, in plain PyTorch."""
    n = x.shape[0]
    m = 2 * half
    tw = table[:: n // m][:half].unsqueeze(0)
    xs = x.view(n // m, m, F.L)
    left = xs[:, :half].clone()
    prod = F.plain_mul(xs[:, half:], tw)
    xs[:, :half] = F.plain_add(left, prod)
    xs[:, half:] = F.plain_sub(left, prod)


def ntt_stage(x: torch.Tensor, table: torch.Tensor, half: int) -> None:
    """K2 wrapper: one stage in place on [n, 8] (plain stage on CPU)."""
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != F.L:
        raise ValueError(f"expected [n, 8] int32, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        plain_stage(x, table, half)
        return
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError(f"no kernel for {x.device} / table on {table.device}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("ntt_stage needs contiguous tensors")
    if table.shape[0] < x.shape[0] // 2:
        raise ValueError("twiddle table shorter than n/2")
    kernels.ntt_stage(x.data_ptr(), table.data_ptr(), x.shape[0], half)


class NTTEngine:
    """Forward and inverse NTT of one size on one device."""

    def __init__(self, log_n: int, device):
        from .poly import powers, scalar

        self.log_n = log_n
        self.n = 1 << log_n
        self.device = torch.device(device)
        omega = root_of_unity(log_n) if log_n else 1
        half = max(1, self.n // 2)
        self.perm = bitrev_perm(log_n, self.device)
        self.fwd_table = powers(scalar(omega, self.device), half)
        self.inv_table = powers(scalar(pow(omega, -1, R_MOD), self.device),
                                half)
        self.n_inv = scalar(pow(self.n, -1, R_MOD), self.device)

    def _run(self, x: torch.Tensor, table: torch.Tensor, stage) -> torch.Tensor:
        if x.shape[0] != self.n:
            raise ValueError(f"NTT of size {self.n} given {x.shape[0]} rows")
        x = x[self.perm]                       # gather: a fresh tensor
        for s in range(self.log_n):
            stage(x, table, 1 << s)
        return x

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[n, 8] coefficients -> evaluations on <omega> (natural order)."""
        return self._run(coeffs, self.fwd_table, ntt_stage)

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        return F.mul(self._run(evals, self.inv_table, ntt_stage), self.n_inv)

    def ntt_plain(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The same transform through the plain stages (any device)."""
        return self._run(coeffs, self.fwd_table, plain_stage)

    def intt_plain(self, evals: torch.Tensor) -> torch.Tensor:
        return F.plain_mul(self._run(evals, self.inv_table, plain_stage),
                           self.n_inv)


@functools.lru_cache(maxsize=None)
def _engine(log_n: int, device: str) -> NTTEngine:
    return NTTEngine(log_n, device)


def ntt_engine(log_n: int, device) -> NTTEngine:
    return _engine(log_n, str(torch.device(device)))
