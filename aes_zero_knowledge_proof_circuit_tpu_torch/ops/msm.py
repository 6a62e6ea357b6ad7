"""Pippenger MSM over BLS12-377 G1 — counterpart of ops/msm_mxu.py.

    points  [N, 2, 12] int32: affine (x, y) in Montgomery Fq limbs
            (x = y = 0 marks infinity), from `points_from_packed`
    scalars [n, 8] int32: standard-form Fr limbs (prover.to_msm_digits)

Steps: signed c-bit digits and the per-window sort by bucket in torch
(`signed_digits`, `bucket_runs`); bucket accumulation and bucket reduction
in kernel K3 (csrc/msm.cu, wrapper `bucket_window_sums`), which returns one
Jacobian sum per window; the window Horner ladder on the host, as
msm_mxu.py does. The plain version of K3 (`plain_bucket_window_sums`) builds
the same window sums from the plain curve formulas of ops/curve.py.
"""

from __future__ import annotations

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    AffinePoint,
    g1_infinity,
    g1_point,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD

from .. import kernels
from ..utils.native import native
from . import curve
from .field import fq_ops, to_u32

FQ = fq_ops()
SCALAR_BITS = 253
MAX_WINDOW_BITS = 13
SEGMENT = 128         # most sorted pairs one K3 thread adds in sequence


def window_bits(n: int) -> int:
    """Window width for an n-point MSM: 13 (20 windows of 4096 signed
    buckets) from 2^16 points, narrower below so buckets stay filled."""
    return max(2, min(MAX_WINDOW_BITS, n.bit_length() - 4))


def n_windows(c: int) -> int:
    # c * (W - 1) >= 255 - c leaves the top window's digit below 2^(c-2),
    # so its signed carry never overflows
    return -(-(SCALAR_BITS + 2) // c)


def points_from_packed(packed: np.ndarray, device) -> torch.Tensor:
    """SRS checkpoint layout [N, 2, 24] uint32 16-bit limbs (standard form)
    -> [N, 2, 12] Montgomery Fq limbs on `device` (counterpart of
    msm_mxu.PlainPoints.from_packed). The Montgomery conversion is one K1
    product by R^2 per coordinate."""
    p = np.ascontiguousarray(packed, dtype=np.uint32)
    limbs = (p[..., 0::2] | (p[..., 1::2] << 16)).astype(np.uint32)
    std = torch.from_numpy(limbs.view(np.int32).copy()).to(device)
    inf = (std == 0).all(dim=-1).all(dim=-1)
    mont = FQ.mul(std.reshape(-1, FQ.L), FQ.const("r2", device))
    mont = mont.reshape(-1, 2, FQ.L)
    mont[inf] = 0
    return mont


def signed_digits(scalars: torch.Tensor, c: int):
    """[n, 8] standard Fr limbs -> (magnitudes [W, n] int64 in [0, 2^(c-1)],
    negative [W, n] bool): s = sum_i d_i 2^(c i), d_i in [-2^(c-1), 2^(c-1)]
    (counterpart of msm_mxu.signed_digits)."""
    v = to_u32(scalars)
    half, full = 1 << (c - 1), 1 << c
    w_count = n_windows(c)
    mags, negs = [], []
    carry = torch.zeros_like(v[:, 0])
    for i in range(w_count):
        bit = c * i
        j, off = bit // 32, bit % 32
        w = v[:, j] >> off if j < 8 else torch.zeros_like(v[:, 0])
        if off + c > 32 and j + 1 < 8:
            w = w | (v[:, j + 1] << (32 - off))
        t = (w & (full - 1)) + carry
        if i == w_count - 1:
            neg = torch.zeros_like(t, dtype=torch.bool)
        else:
            neg = t >= half
        d = torch.where(neg, full - t, t)
        carry = neg.to(torch.int64)
        mags.append(d)
        negs.append(neg & (d != 0))
    return torch.stack(mags), torch.stack(negs)


def bucket_runs(mags: torch.Tensor, negs: torch.Tensor, buckets: int):
    """Sort the (window, point) pairs by bucket: returns the point index
    (int32) and sign (uint8) of each sorted pair and the [W*(B+1)+1] int64
    run offsets of bucket b of window w at w*(B+1)+b."""
    w_count, n = mags.shape
    key = (torch.arange(w_count, device=mags.device)[:, None] * (buckets + 1)
           + mags).reshape(-1)
    order = torch.argsort(key)
    idx = (order % n).to(torch.int32)
    neg = negs.reshape(-1)[order].to(torch.uint8)
    counts = torch.bincount(key, minlength=w_count * (buckets + 1))
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=mags.device)
    offsets[1:] = torch.cumsum(counts, dim=0)
    return idx, neg, offsets


# -- K3 and its plain version -------------------------------------------------


def _chunk(buckets: int) -> int:
    """Buckets per thread in the reduction's first pass: about sqrt(B), so
    the two running-sum passes are about equally long."""
    return 1 << ((buckets.bit_length() - 1 + 1) // 2)


def bucket_window_sums(points: torch.Tensor, idx: torch.Tensor,
                       neg: torch.Tensor, offsets: torch.Tensor,
                       windows: int, buckets: int) -> torch.Tensor:
    """K3 wrapper: [W, 3, 12] Jacobian window sums S_w = sum_b b * B_w,b
    (Montgomery Fq). Plain version on CPU tensors, the kernel on CUDA."""
    if points.dtype != torch.int32 or points.dim() != 3 or \
            points.shape[1:] != (2, FQ.L):
        raise ValueError(f"points must be [N, 2, 12] int32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if offsets.shape[0] != windows * (buckets + 1) + 1:
        raise ValueError("offsets do not match windows x buckets")
    if points.device.type == "cpu":
        return plain_bucket_window_sums(points, idx, neg, offsets, windows,
                                        buckets)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    for t, dt in ((idx, torch.int32), (neg, torch.uint8),
                  (offsets, torch.int64)):
        if t.dtype != dt or t.device != points.device or not t.is_contiguous():
            raise ValueError(f"bad MSM run tensor {t.dtype} on {t.device}")
    if idx.shape[0] and int(idx.max()) >= points.shape[0]:
        raise ValueError("point index out of range")
    points = points.contiguous()
    seg_lo, seg_hi, first = _segments(offsets, windows, buckets)
    chunk = _chunk(buckets)
    dev = points.device
    seg_scratch = torch.empty((max(1, seg_lo.shape[0]), 3, FQ.L),
                              dtype=torch.int32, device=dev)
    bucket_scratch = torch.empty((windows * buckets, 3, FQ.L),
                                 dtype=torch.int32, device=dev)
    chunk_scratch = torch.empty((windows * (buckets // chunk), 2, 3, FQ.L),
                                dtype=torch.int32, device=dev)
    out = torch.empty((windows, 3, FQ.L), dtype=torch.int32, device=dev)
    kernels.msm_g1(points.data_ptr(), idx.data_ptr(), neg.data_ptr(),
                   seg_lo.data_ptr(), seg_hi.data_ptr(), seg_lo.shape[0],
                   first.data_ptr(), windows, buckets, chunk,
                   chunk.bit_length() - 1, seg_scratch.data_ptr(),
                   bucket_scratch.data_ptr(), chunk_scratch.data_ptr(),
                   out.data_ptr())
    return out


def _segments(offsets: torch.Tensor, windows: int, buckets: int):
    """Cut each bucket's run (buckets 1..B of every window) into segments of
    at most SEGMENT pairs: (seg_lo, seg_hi) int64 bounds in the sorted pairs
    and the [W*B + 1] int64 offsets of each bucket's first segment."""
    runs = offsets.view(-1)
    starts = runs[:-1].view(windows, buckets + 1)[:, 1:].reshape(-1)
    counts = (runs[1:] - runs[:-1]).view(windows, buckets + 1)[:, 1:]
    counts = counts.reshape(-1)
    nseg = (counts + SEGMENT - 1) // SEGMENT
    first = torch.zeros(nseg.shape[0] + 1, dtype=torch.int64,
                        device=offsets.device)
    first[1:] = torch.cumsum(nseg, dim=0)
    owner = torch.repeat_interleave(
        torch.arange(nseg.shape[0], device=offsets.device), nseg)
    k = torch.arange(owner.shape[0], device=offsets.device) - first[owner]
    seg_lo = (starts[owner] + k * SEGMENT).contiguous()
    seg_hi = torch.minimum(seg_lo + SEGMENT,
                           starts[owner] + counts[owner]).contiguous()
    return seg_lo, seg_hi, first


def plain_bucket_sums(points, idx, neg, offsets, windows: int, buckets: int):
    """Bucket totals [W, B] (as a Jacobian triple of [W*B, 12]): the sorted
    pairs of each bucket summed by a pairwise tree (`curve.run_sums`)."""
    dev = points.device
    counts = offsets[1:] - offsets[:-1]
    key = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts)
    pts = points[idx.to(torch.int64)]
    x, y = pts[:, 0], pts[:, 1]
    keep = (key % (buckets + 1) != 0) & ~(FQ.is_zero(x) & FQ.is_zero(y))
    key, x, y, sneg = key[keep], x[keep], y[keep], neg[keep].bool()
    y = FQ.select(sneg, FQ.plain_sub(torch.zeros_like(y), y), y)
    one = FQ.const("one", dev).expand_as(x)
    table = curve.run_sums(key, (x, y, one.clone()), windows * (buckets + 1),
                           affine=True)
    sel = (torch.arange(windows * (buckets + 1), device=dev)
           % (buckets + 1)) != 0
    return tuple(t[sel] for t in table)


def plain_fold(bsum, windows: int, buckets: int) -> torch.Tensor:
    """[W, 3, 12] window sums S = sum_j (j + 1) B_j from the bucket totals
    [W*B] (bucket b at j = b - 1), in the two chunked running-sum passes of
    csrc/msm.cu (`bucket_chunk_reduce`, `window_combine`)."""
    dev = bsum[0].device
    chunk = _chunk(buckets)
    nch = buckets // chunk
    # per (window, chunk) running sums from the top bucket down
    cols = tuple(t.reshape(windows * nch, chunk, FQ.L) for t in bsum)
    run = curve.infinity(windows * nch, dev)
    acc = curve.infinity(windows * nch, dev)
    for j in range(chunk - 1, -1, -1):
        run = curve.jac_add(run, tuple(c[:, j] for c in cols))
        acc = curve.jac_add(acc, run)
    a_c = tuple(t.reshape(windows, nch, FQ.L) for t in acc)
    r_c = tuple(t.reshape(windows, nch, FQ.L) for t in run)
    # S = sum_c A_c + CH * sum_c c R_c
    run = curve.infinity(windows, dev)
    acc = curve.infinity(windows, dev)
    for c in range(nch - 1, 0, -1):
        run = curve.jac_add(run, tuple(t[:, c] for t in r_c))
        acc = curve.jac_add(acc, run)
    for _ in range(chunk.bit_length() - 1):
        acc = curve.jac_double(acc)
    for c in range(nch):
        acc = curve.jac_add(acc, tuple(t[:, c] for t in a_c))
    return torch.stack(acc, dim=1)


def plain_bucket_window_sums(points, idx, neg, offsets, windows: int,
                             buckets: int) -> torch.Tensor:
    """Plain version of K3: the same three phases as csrc/msm.cu."""
    bsum = plain_bucket_sums(points, idx, neg, offsets, windows, buckets)
    return plain_fold(bsum, windows, buckets)


# -- top level ------------------------------------------------------------------


def window_points(sums: torch.Tensor):
    """[W, 3, 12] Jacobian Montgomery window sums -> host affine points."""
    xs = FQ.to_ints(sums[:, 0])
    ys = FQ.to_ints(sums[:, 1])
    zs = FQ.to_ints(sums[:, 2])
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(g1_infinity())
            continue
        zi = pow(z, -1, Q_MOD)
        zi2 = zi * zi % Q_MOD
        out.append(g1_point(x * zi2 % Q_MOD, y * zi2 * zi % Q_MOD))
    return out


def horner(win_pts, c: int) -> AffinePoint:
    acc = g1_infinity()
    for p in reversed(win_pts):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(p)
    return acc


def msm(points: torch.Tensor, scalars: torch.Tensor) -> AffinePoint:
    """sum_i scalars[i] * points[i] over the first len(scalars) points."""
    n = scalars.shape[0]
    if n == 0:
        return g1_infinity()
    if points.shape[0] < n:
        raise ValueError(f"{points.shape[0]} points < {n} scalars")
    c = window_bits(n)
    buckets = 1 << (c - 1)
    mags, negs = signed_digits(scalars, c)
    idx, neg, offsets = bucket_runs(mags, negs, buckets)
    sums = bucket_window_sums(points[:n], idx, neg, offsets, mags.shape[0],
                              buckets)
    return horner(window_points(sums), c)


def native_msm(packed: np.ndarray, scalars: torch.Tensor) -> AffinePoint:
    """The native C++ Pippenger (host) on the SRS checkpoint layout and
    [n, 8] standard Fr limbs: the oracle K3 and K4 are held to."""
    limbs = to_u32(scalars.cpu()).numpy().astype(np.uint64)
    u64 = limbs[:, 0::2] | (limbs[:, 1::2] << np.uint64(32))
    out = native().g1_msm_packed(np.ascontiguousarray(packed[: len(u64)]),
                                 u64)
    if out is None:
        raise RuntimeError("native Pippenger failed")
    return out
