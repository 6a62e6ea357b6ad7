"""Pippenger MSM over BLS12-377 G1 — counterpart of ops/msm_mxu.py.

    points  [N, 2, 12] int32: affine (x, y) in Montgomery Fq limbs
            (x = y = 0 marks infinity), from `points_from_packed`
    scalars [n, 8] int32: standard-form Fr limbs (prover.to_msm_digits)

Steps: signed c-bit digits and the per-window sort by bucket in torch
(`signed_digits`, `bucket_runs`); then kernel K3 (csrc/msm.cu, wrapper
`bucket_msm`): bucket accumulation in segments, and the reduction of
csrc/curve.cuh (segment merge, bucket slices, offset multiples, sum trees,
the window Horner ladder) down to the MSM as one XYZZ point [4, 12] that
stays on the device. The host reads points only when it needs them
(`xyzz_to_affine`): `msm` once per MSM, the prover once per batch of MSMs.

The digits, sort and segments of a window take about PAIR_BYTES a point on
the device, so `msm_point` cuts the windows into consecutive groups of at
most GROUP_BYTES (`window_groups`): each group's digits are sorted and
summed into its rows of the window sums, and the last group's launch runs
the ladder over all of them. Up to 2^22 points the 20 windows are one
group; at 2^26 they are seven groups of three (the last of two), at the
2^26 + 1 points of a 1 KB key's whole SRS ten groups of two.

The plain version (`plain_bucket_msm`) sums each bucket with the plain
curve formulas of ops/curve.py (pairwise trees), then runs the kernel's
reduction step for step (`plain_window_sums`: the same slices, offset
multiples and sum trees, in Jacobian coordinates) and its ladder on host
integers (`plain_horner`: one sequential row, where a plain tensor row op
would cost milliseconds each).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import spans
from ..utils.native import native
from . import curve
from .curve_host import AffinePoint, g1_infinity, g1_point
from .field import fq_ops, to_u32
from .field_params import Q_MOD

FQ = fq_ops()
SCALAR_BITS = 253
MAX_WINDOW_BITS = 13
SEGMENT = 32          # most sorted pairs one K3 thread adds in sequence
PLAIN_PAIRS = 1 << 23  # sorted pairs the plain version sums at once
# device bytes the windows of one group may take: one group up to 2^22
# points on both engines (as before groups existed), and 11.7 GiB for a
# 2^26-point K3 MSM's own buffers, against 18.5 at a 20 GiB budget, at no
# measured cost in time (scripts/reckon_1kb.py on an H100)
GROUP_BYTES = 12 << 30
# device bytes a (window, point) pair takes while its group is summed: the
# measured peak of one msm_point over its 20 N pairs was 63.5 B a pair at
# 2^22 and 2^24 on an H100 (scripts/reckon_1kb.py): digits, sort keys and
# order, idx and neg, segment bounds and segment sums
PAIR_BYTES = 64


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


def window_groups(windows: int, n: int, pair_bytes: int,
                  budget: int) -> List[Tuple[int, int]]:
    """Consecutive groups [w0, w1) of the windows of an n-point MSM whose
    pairs, at pair_bytes each, take at most `budget` bytes (one window a
    group at least): every window lies in exactly one group."""
    per = max(1, budget // max(1, n * pair_bytes))
    return [(w0, min(windows, w0 + per)) for w0 in range(0, windows, per)]


def _limb(scalars: torch.Tensor, j: int) -> torch.Tensor:
    """Limb j of [n, 8] Fr limbs as unsigned int64 (0 past the top)."""
    if j >= scalars.shape[1]:
        return torch.zeros(scalars.shape[0], dtype=torch.int64,
                           device=scalars.device)
    return scalars[:, j].to(torch.int64) & 0xFFFFFFFF


def digit_windows(scalars: torch.Tensor, c: int):
    """Yield each window's (magnitude [n] int64 in [0, 2^(c-1)], negative
    [n] bool), lowest first: s = sum_i d_i 2^(c i), d_i in [-2^(c-1),
    2^(c-1)] (counterpart of msm_mxu.signed_digits). Only the carry passes
    from one window to the next, so a group of windows needs no other's
    digits."""
    half, full = 1 << (c - 1), 1 << c
    w_count = n_windows(c)
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64,
                        device=scalars.device)
    for i in range(w_count):
        j, off = divmod(c * i, 32)
        w = _limb(scalars, j) >> off
        if off + c > 32 and j + 1 < 8:
            w = w | (_limb(scalars, j + 1) << (32 - off))
        t = (w & (full - 1)) + carry
        if i == w_count - 1:
            neg = torch.zeros_like(t, dtype=torch.bool)
        else:
            neg = t >= half
        d = torch.where(neg, full - t, t)
        carry = neg.to(torch.int64)
        yield d, neg & (d != 0)


def signed_digits(scalars: torch.Tensor, c: int):
    """[n, 8] standard Fr limbs -> (magnitudes [W, n] int64 in [0, 2^(c-1)],
    negative [W, n] bool) of every window (`digit_windows`)."""
    mags, negs = zip(*digit_windows(scalars, c))
    return torch.stack(mags), torch.stack(negs)


def bucket_runs(mags: torch.Tensor, negs: torch.Tensor, buckets: int):
    """Sort the (window, point) pairs by bucket: returns the point index
    (int32) and sign (uint8) of each sorted pair and the [W*(B+1)+1] int64
    run offsets of bucket b of window w at w*(B+1)+b. The sort key
    w*(B+1)+b is int32 (W (B + 1) < 2^31)."""
    w_count, n = mags.shape
    dev = mags.device
    key = (torch.arange(w_count, dtype=torch.int32, device=dev)[:, None]
           * (buckets + 1) + mags.to(torch.int32)).reshape(-1)
    keys, order = torch.sort(key)
    del key
    idx = (order % n).to(torch.int32)
    neg = negs.reshape(-1)[order].to(torch.uint8)
    del order
    offsets = torch.searchsorted(keys, torch.arange(
        w_count * (buckets + 1) + 1, dtype=torch.int32, device=dev))
    return idx, neg, offsets


# -- K3 and its plain version -------------------------------------------------

MAX_BLOCK = 64   # threads of a reduction block (csrc/curve.cuh MAX_BLOCK)


def reduce_geometry(buckets: int):
    """(slice_log, block_log) of the reduction over `buckets` buckets a
    window: each thread sums a slice of 2^slice_log buckets, a block joins
    2^block_log slices. Four buckets a thread from 1024 buckets up, so that
    at 4096 buckets x 20 windows the 320 blocks of 64 threads are one wave
    on the card (four blocks an SM at up to 255 registers), two from 128."""
    slice_log = 2 if buckets >= 1024 else 1 if buckets >= 128 else 0
    block_log = min(MAX_BLOCK.bit_length() - 1,
                    buckets.bit_length() - 1 - slice_log)
    return slice_log, block_log


def merge_passes(most: int) -> int:
    """Levels of the pairwise merge that joins up to `most` partial sums of
    one bucket."""
    return max(0, most - 1).bit_length()


def merge_plan(first: torch.Tensor, passes: int) -> torch.Tensor:
    """[passes, nb + 1] int64 from the [nb + 1] offsets of each bucket's
    first partial sum: row p is the running count, over the buckets, of the
    joins at merge level p (stride 2^p), where a bucket of m partial sums
    has (m + 2^p - 1) >> (p + 1). The merge kernel's thread u does the u-th
    join of its level."""
    m = (first[1:] - first[:-1])[None, :]
    step = 2 ** torch.arange(passes, dtype=torch.int64,
                             device=first.device)[:, None]
    out = torch.zeros((passes, m.shape[1] + 1), dtype=torch.int64,
                      device=first.device)
    out[:, 1:] = torch.cumsum((m + step - 1) // (2 * step), dim=1)
    return out


def _check_points(points: torch.Tensor) -> None:
    if points.dtype != torch.int32 or points.dim() != 3 or \
            points.shape[1:] != (2, FQ.L):
        raise ValueError(f"points must be [N, 2, 12] int32, got "
                         f"{tuple(points.shape)} {points.dtype}")


def reduce_scratch(windows: int, buckets: int, device, rows: int = 0):
    """(block_sums, counters, out) for one reduction launch over `windows`
    windows; block_sums has at least `rows` rows, and the counters start at
    zero."""
    slice_log, block_log = reduce_geometry(buckets)
    bpw = buckets >> (slice_log + block_log)
    empty = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                       device=device)
    return (empty(max(rows, windows * bpw), 4, FQ.L),
            torch.zeros(windows, dtype=torch.int32, device=device),
            empty(4, FQ.L))


def bucket_msm(points: torch.Tensor, idx: torch.Tensor, neg: torch.Tensor,
               offsets: torch.Tensor, windows: int, buckets: int, c: int,
               wsums: Optional[torch.Tensor] = None, first: int = 0,
               ladder: bool = True):
    """K3 wrapper over the sorted pairs of `windows` windows: their window
    sums S_w = sum_b b B_w,b go to rows first .. first + windows of `wsums`
    ([W, 4, 12] XYZZ, the whole MSM's; made here, W = windows, when None),
    and with `ladder` the MSM sum_w 2^(c w) S_w over all W rows follows.
    Returns (the MSM as one XYZZ point [4, 12], or None without `ladder`;
    wsums), Montgomery Fq. Plain version on CPU tensors, the kernel on
    CUDA."""
    _check_points(points)
    if offsets.shape[0] != windows * (buckets + 1) + 1:
        raise ValueError("offsets do not match windows x buckets")
    if wsums is None:
        wsums = torch.empty((windows, 4, FQ.L), dtype=torch.int32,
                            device=points.device)
    if wsums.shape[1:] != (4, FQ.L) or not 0 <= first <= \
            wsums.shape[0] - windows or wsums.device != points.device:
        raise ValueError(f"window sums {tuple(wsums.shape)} on "
                         f"{wsums.device} cannot take windows {first} .. "
                         f"{first + windows}")
    if points.device.type == "cpu":
        return plain_bucket_msm(points, idx, neg, offsets, windows, buckets,
                                c, wsums, first, ladder)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    kernels.check_device(points)
    for t, dt in ((idx, torch.int32), (neg, torch.uint8),
                  (offsets, torch.int64)):
        if t.dtype != dt or t.device != points.device or not t.is_contiguous():
            raise ValueError(f"bad MSM run tensor {t.dtype} on {t.device}")
    if not wsums.is_contiguous():
        raise ValueError("window sums must be contiguous")
    points = points.contiguous()
    seg_lo, seg_hi, _owner, seg_first = _segments(offsets, windows, buckets,
                                                  idx.shape[0])
    slice_log, block_log = reduce_geometry(buckets)
    seg_scratch = torch.empty((max(1, seg_lo.shape[0]), 4, FQ.L),
                              dtype=torch.int32, device=points.device)
    block_sums, counters, out = reduce_scratch(windows, buckets,
                                               points.device)
    # a bucket holds at most the n pairs of its window
    passes = merge_passes(-(-(idx.shape[0] // windows) // SEGMENT))
    prefix = merge_plan(seg_first, passes)
    kernels.msm_g1(points.data_ptr(), idx.data_ptr(), neg.data_ptr(),
                   seg_lo.data_ptr(), seg_hi.data_ptr(), prefix.data_ptr(),
                   seg_lo.shape[0], seg_first.data_ptr(), passes, windows,
                   buckets, c, slice_log, block_log, seg_scratch.data_ptr(),
                   block_sums.data_ptr(), wsums[first].data_ptr(),
                   counters.data_ptr(), wsums.data_ptr(),
                   wsums.shape[0] if ladder else 0, out.data_ptr())
    return (out if ladder else None), wsums


def _segments(offsets: torch.Tensor, windows: int, buckets: int,
              pairs: int):
    """Cut each bucket's run (buckets 1..B of every window) into segments of
    at most SEGMENT pairs: (seg_lo, seg_hi) int64 bounds in the sorted
    pairs, the bucket that owns each segment, and the [W*B + 1] int64
    offsets of each bucket's first segment. The number of segments depends
    on the data, so the bounds have room for the most there can be
    (pairs / SEGMENT + W*B) and the rest are empty: no value comes back to
    the host."""
    seg = SEGMENT
    dev = offsets.device
    runs = offsets.view(-1)
    starts = runs[:-1].view(windows, buckets + 1)[:, 1:].reshape(-1)
    counts = (runs[1:] - runs[:-1]).view(windows, buckets + 1)[:, 1:]
    counts = counts.reshape(-1)
    nseg = (counts + seg - 1) // seg
    first = torch.zeros(nseg.shape[0] + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(nseg, dim=0)
    cap = -(-pairs // seg) + windows * buckets
    k = torch.arange(cap, device=dev)
    owner = torch.searchsorted(first[1:], k, right=True).clamp_(
        max=nseg.shape[0] - 1)
    seg_lo = starts[owner] + (k - first[owner]) * seg
    seg_hi = torch.minimum(seg_lo + seg, starts[owner] + counts[owner])
    seg_hi = torch.where(k < first[-1], seg_hi, seg_lo)
    return seg_lo.contiguous(), seg_hi.contiguous(), owner, first


def plain_bucket_sums(points, idx, neg, offsets, windows: int, buckets: int):
    """Bucket totals [W, B] (as a Jacobian triple of [W*B, 12]): the sorted
    pairs of each bucket summed by a pairwise tree (`curve.run_sums`), for
    a group of windows of about PLAIN_PAIRS pairs at a time (the buckets of
    two windows never meet)."""
    per = buckets + 1
    group = max(1, PLAIN_PAIRS * windows // max(1, int(offsets[-1])))
    parts = []
    for w0 in range(0, windows, group):
        w1 = min(windows, w0 + group)
        lo, hi = int(offsets[w0 * per]), int(offsets[w1 * per])
        parts.append(_plain_group_sums(
            points, idx[lo:hi], neg[lo:hi],
            offsets[w0 * per:w1 * per + 1] - lo, w1 - w0, buckets))
    return tuple(torch.cat(t) for t in zip(*parts))


def _plain_group_sums(points, idx, neg, offsets, windows: int, buckets: int):
    """plain_bucket_sums over one group of windows (offsets from its own
    first pair)."""
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


def add_multiple(acc, run, k: torch.Tensor):
    """acc + k run per row (k >= 0 int64), by the kernel's double-and-add
    from the top bit of k: rows whose k has fewer bits skip the leading
    steps, as their threads do."""
    m = run
    top = int(k.max()).bit_length() - 1 if k.numel() else -1
    for bit in range(top - 1, -1, -1):
        live = (k >> (bit + 1)) != 0       # the top bit of k is above `bit`
        d = curve.jac_double(m)
        d = curve.select(((k >> bit) & 1).bool() & live, curve.jac_add(d, run),
                         d)
        m = curve.select(live, d, m)
    return curve.select(k != 0, curve.jac_add(acc, m), acc)


def add_tree(p, n: int):
    """The kernel's sum tree over consecutive groups of n rows (n a power
    of two): neighbours join pairwise, one add a level."""
    while n > 1:
        p = curve.jac_add(tuple(t[0::2] for t in p), tuple(t[1::2] for t in p))
        n //= 2
    return p


def plain_window_sums(bsum, windows: int, buckets: int):
    """Window sums S_w = sum_b b B_w,b (a Jacobian triple of [W, 12]) from
    the bucket totals [W*B] (bucket b at b - 1), step for step as the
    kernel's reduction: running sums over slices of 2^slice_log buckets
    from the top bucket down, each slice's offset multiple k R, then the
    sum tree over each block's slices and over each window's blocks."""
    dev = bsum[0].device
    slice_log, block_log = reduce_geometry(buckets)
    s = 1 << slice_log
    n = windows * buckets // s
    cols = tuple(t.reshape(n, s, FQ.L) for t in bsum)
    run = curve.infinity(n, dev)
    acc = curve.infinity(n, dev)
    for j in range(s - 1, -1, -1):
        run = curve.jac_add(run, tuple(t[:, j] for t in cols))
        acc = curve.jac_add(acc, run)
    k = (torch.arange(n, device=dev) % (buckets // s)) << slice_log
    acc = add_multiple(acc, run, k)
    acc = add_tree(acc, 1 << block_log)
    return add_tree(acc, buckets >> (slice_log + block_log))


def jac_to_xyzz(p) -> torch.Tensor:
    """Jacobian (X, Y, Z) rows -> [N, 4, 12] XYZZ (X, Y, Z^2, Z^3)."""
    x, y, z = p
    zz = FQ.plain_mul(z, z)
    return torch.stack([x, y, zz, FQ.plain_mul(zz, z)], dim=1)


def xyzz_to_affine(t: torch.Tensor) -> List[AffinePoint]:
    """[..., 4, 12] XYZZ Montgomery points (any device) -> host affine
    points, with one copy to the host."""
    with spans.wait("xyzz_to_affine", readback=spans.nbytes(t)):
        t = t.reshape(-1, 4, FQ.L).cpu()
    arr = t.numpy()
    xs, ys, zzs, zzzs = (FQ.host_ints(arr[:, i]) for i in range(4))
    out = []
    for x, y, zz, zzz in zip(xs, ys, zzs, zzzs):
        if zz == 0:
            out.append(g1_infinity())
        else:
            out.append(g1_point(x * pow(zz, -1, Q_MOD) % Q_MOD,
                                y * pow(zzz, -1, Q_MOD) % Q_MOD))
    return out


def affine_to_xyzz(p: AffinePoint, device) -> torch.Tensor:
    if p.inf:
        return torch.zeros((4, FQ.L), dtype=torch.int32, device=device)
    return FQ.from_ints([p.x, p.y, 1, 1], device)


def plain_horner(wsums: torch.Tensor, c: int) -> AffinePoint:
    """The kernel's ladder sum_w 2^(c w) S_w, from the top window down, on
    host integers."""
    acc = g1_infinity()
    for p in reversed(xyzz_to_affine(wsums)):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(p)
    return acc


def plain_reduce(bsum, windows: int, buckets: int, c: int,
                 wsums: Optional[torch.Tensor] = None, first: int = 0,
                 ladder: bool = True):
    """(MSM point [4, 12] or None, window sums [W, 4, 12]) from the bucket
    totals of `windows` windows, both XYZZ, as the kernel's reduction
    returns them: the group's sums land in rows first .. first + windows
    of `wsums` (made here when None) and `ladder` runs over all rows."""
    group = jac_to_xyzz(plain_window_sums(bsum, windows, buckets))
    if wsums is None:
        wsums = group
    else:
        wsums[first:first + windows] = group
    if not ladder:
        return None, wsums
    return affine_to_xyzz(plain_horner(wsums, c), wsums.device), wsums


def plain_bucket_msm(points, idx, neg, offsets, windows: int, buckets: int,
                     c: int, wsums: Optional[torch.Tensor] = None,
                     first: int = 0, ladder: bool = True):
    """Plain version of K3: bucket totals, then the kernel's reduction."""
    bsum = plain_bucket_sums(points, idx, neg, offsets, windows, buckets)
    return plain_reduce(bsum, windows, buckets, c, wsums, first, ladder)


# -- top level ------------------------------------------------------------------


def msm_point(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i scalars[i] * points[i] over the first len(scalars) points, as
    one XYZZ point [4, 12] on the points' device; nothing is synchronized."""
    n = scalars.shape[0]
    if n == 0:
        return torch.zeros((4, FQ.L), dtype=torch.int32, device=points.device)
    if points.shape[0] < n:
        raise ValueError(f"{points.shape[0]} points < {n} scalars")
    c = window_bits(n)
    buckets = 1 << (c - 1)
    w_count = n_windows(c)
    digits = digit_windows(scalars, c)
    wsums = torch.empty((w_count, 4, FQ.L), dtype=torch.int32,
                        device=points.device)
    for w0, w1 in window_groups(w_count, n, PAIR_BYTES, GROUP_BYTES):
        mags, negs = zip(*(next(digits) for _ in range(w0, w1)))
        runs = bucket_runs(torch.stack(mags), torch.stack(negs), buckets)
        del mags, negs
        out, _ = bucket_msm(points[:n], *runs, w1 - w0, buckets, c, wsums,
                            w0, ladder=w1 == w_count)
        del runs
    return out


def msm(points: torch.Tensor, scalars: torch.Tensor) -> AffinePoint:
    """sum_i scalars[i] * points[i] as a host affine point."""
    return xyzz_to_affine(msm_point(points, scalars))[0]


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
