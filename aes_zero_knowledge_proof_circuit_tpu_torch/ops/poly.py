"""Polynomial toolbox over Fr limb tensors — counterpart of ops/poly_jax.py.

A "dpoly" is a [len, 8] int32 tensor of Montgomery coefficients (low ->
high); a scalar is a [1, 8] row that broadcasts. Products go through kernel
K1 and transforms through K2 (ops/ntt.py). Sums over many rows (tree sums,
prefix sums, segment sums, block suffix sums) are exact int64 sums of the
16-bit half-limbs folded back into the field once (`fold_wide`), the same
V = V_lo + R * V_hi trick as poly_jax.segment_sum_mod. The half-limbs take
four times the rows' bytes, so those sums run over SUM_ROWS rows at a
time: at 2^26 rows (a 1 KB proof's openings) one pass took 32 GiB of the
card at once. No four-step paths: they existed for a 16 GB chip.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .field_params import R_MOD

from .field import MASK16, fr_ops, from_halves, halves, table_built
from .ntt import ntt_engine

F = fr_ops()
L = F.L
# rows whose half-limbs (1 GiB) one exact sum takes: every sum of a 64-byte
# proof (at most 2^22 + 1 rows) still runs in one pass
SUM_ROWS = 1 << 23


def dpoly(ints: Sequence[int], device) -> torch.Tensor:
    """Host ints -> [len, 8] Montgomery coefficients on `device`."""
    return F.from_ints(ints, device)


def scalar(v: int, device) -> torch.Tensor:
    """Host int -> [1, 8] Montgomery row."""
    return F.from_ints([v], device)


def zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n, L), dtype=torch.int32, device=device)


def pad_to(p: torch.Tensor, n: int) -> torch.Tensor:
    if p.shape[0] > n:
        raise ValueError(f"cannot pad {p.shape[0]} rows to {n}")
    if p.shape[0] == n:
        return p
    return torch.cat([p, zeros(n - p.shape[0], p.device)])


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    n = max(p.shape[0], q.shape[0])
    return F.add(pad_to(p, n), pad_to(q, n))


def sub(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    n = max(p.shape[0], q.shape[0])
    return F.sub(pad_to(p, n), pad_to(q, n))


def scale(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return F.mul(p, s)


def ntt_to(log_n: int, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate a dpoly (len <= 2^log_n) on the canonical 2^log_n domain."""
    eng = ntt_engine(log_n, coeffs.device)
    return eng.ntt(pad_to(coeffs, eng.n))


def intt(log_n: int, evals: torch.Tensor) -> torch.Tensor:
    return ntt_engine(log_n, evals.device).intt(evals)


@functools.lru_cache(maxsize=None)
def _coset_powers(log_n: int, g: int, inverse: bool, device: str
                  ) -> torch.Tensor:
    gg = pow(g, -1, R_MOD) if inverse else g % R_MOD
    pw = powers(scalar(gg, device), 1 << log_n)
    table_built(device)
    return pw


def ntt_coset(log_n: int, coeffs: torch.Tensor, g: int) -> torch.Tensor:
    """Evaluate on the coset g*<w_n>: scale coefficient i by g^i, NTT."""
    pw = _coset_powers(log_n, g, False, str(coeffs.device))
    return ntt_to(log_n, F.mul(pad_to(coeffs, 1 << log_n), pw))


def intt_coset(log_n: int, evals: torch.Tensor, g: int) -> torch.Tensor:
    """Interpolate from evaluations on g*<w_n> (exact for deg < 2^log_n)."""
    pw = _coset_powers(log_n, g, True, str(evals.device))
    return F.mul(intt(log_n, evals), pw)


def powers(z: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 8]: 1, z, ..., z^(n-1), by doubling: rows [k, 2k) = rows [0, k)
    times z^k (log2 n products, n rows of work in all)."""
    out = zeros(n, z.device)
    out[:1] = F.const("one", z.device)
    zk = z
    have = 1
    while have < n:
        m = min(have, n - have)
        out[have:have + m] = F.mul(out[:m], zk)
        have += m
        if have < n:
            zk = F.mul(zk, zk)
    return out


def fold_wide(cols: torch.Tensor) -> torch.Tensor:
    """[.., 16] int64 column sums of 16-bit half-limbs of Montgomery rows
    (each column < 2^47, non-negative) -> [.., 8] reduced Montgomery rows of
    the field sum: V = V_lo + 2^256 V_hi, V mod r = (V_lo mod r) + V_hi R."""
    shape = cols.shape[:-1]
    c = cols.reshape(-1, 2 * L).clone()
    for j in range(2 * L - 1):
        c[:, j + 1] += c[:, j] >> 16
        c[:, j] &= MASK16
    hi = c[:, -1] >> 16
    c[:, -1] &= MASK16
    lo = from_halves(c)
    r2 = F.const("r2", cols.device)
    lo_mod = F.mul(F.mul(lo, r2), F.const("one_raw", cols.device))
    hi_limbs = torch.zeros_like(lo)
    hi_limbs[:, 0] = hi.to(torch.int32)
    return F.add(lo_mod, F.mul(hi_limbs, r2)).reshape(*shape, L)


def _cumsum0(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive cumsum along axis 0, run as a scan along the innermost
    axis (PyTorch's CUDA scan along an outer axis is ~20x slower)."""
    t = x.movedim(0, -1)
    if reverse:
        t = t.flip(-1)
    t = t.contiguous().cumsum(dim=-1)
    if reverse:
        t = t.flip(-1)
    return t.movedim(-1, 0)


def tree_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum along axis 0 (mod r) -> [1, 8]: the column sums of SUM_ROWS rows
    at a time, added exactly (each column stays below 2^16 N)."""
    cols = sum(halves(vals[a:a + SUM_ROWS]).sum(dim=0, keepdim=True)
               for a in range(0, vals.shape[0], SUM_ROWS))
    return fold_wide(cols if vals.shape[0] else halves(vals).sum(
        dim=0, keepdim=True))


def prefix_sum(vals: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) sums along axis 0 — the prefix-sum use of
    scan_utils.hillis_scan, as exact int64 cumsums of SUM_ROWS rows at a
    time, each chunk's sums then offset by the total before it (mod r)."""
    out = torch.empty_like(vals)
    starts = range(0, vals.shape[0], SUM_ROWS)
    carry = None
    for a in (reversed(starts) if reverse else starts):
        part = fold_wide(_cumsum0(halves(vals[a:a + SUM_ROWS]), reverse))
        if carry is not None:
            part = F.add(part, carry)
        out[a:a + SUM_ROWS] = part
        carry = part[:1] if reverse else part[-1:]
    return out


def div_vanishing(p: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Divide by X^m - 1: (quotient, remainder[m]) with
    h_{km+i} = sum_{l>k} p_{lm+i} and r_i = p_i + h_i."""
    n = p.shape[0]
    if n <= m:
        return zeros(1, p.device), pad_to(p, m)
    blocks = -(-n // m)
    pp = pad_to(p, blocks * m).reshape(blocks, m, L)
    # the columns' suffix sums are independent: SUM_ROWS rows at a time
    width = max(1, SUM_ROWS // blocks)
    parts = [fold_wide(_cumsum0(halves(pp[:, a:a + width]), reverse=True))
             for a in range(0, m, width)]
    suffix = torch.cat(parts, dim=1)
    h = suffix[1:].reshape((blocks - 1) * m, L)
    rem = F.add(pp[0], suffix[1])
    return h, rem


def segment_sum_mod(values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Field sums of [N, 8] rows by segment id -> [num_segments, 8]."""
    cols = torch.zeros((num_segments, 2 * L), dtype=torch.int64,
                       device=values.device)
    for a in range(0, values.shape[0], SUM_ROWS):
        cols.index_add_(0, seg_ids[a:a + SUM_ROWS].to(torch.int64),
                        halves(values[a:a + SUM_ROWS]))
    return fold_wide(cols)
