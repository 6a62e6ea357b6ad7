"""The 8-bit bucket MSM stages — counterpart of ops/msm_pallas.py.

    points   [N, 2, 12] int32: affine (x, y) in Montgomery Fq limbs
             (x = y = 0 marks infinity), from `points_from_packed`
    digits16 [n, 16] int32: standard-form scalars as 16-bit limbs

Stages, as in the JAX module, for a group of the 32 windows at a time
(all 32 at once up to 2^22 points; `window_groups` of ops/msm.py at
PAIR_BYTES a pair keeps a group within GROUP_BYTES, so 2^25 points run in
groups of four), the last group's launch joining every window:

1. `window_digits`: 32 unsigned 8-bit windows taken from the 16 limbs,
   least significant first (`_window_digits`).
2. `land`: the per-window sort by digit (torch glue, as the JAX module
   sorts in XLA outside its kernel). The pairs of digit 0, the dump bucket,
   are dropped and never added; `idx` keeps the point of every other pair in
   (window, digit) order, bucket w * 256 + d - 1. Each bucket is summed by a
   pairwise tree, and `first[l]` holds the offsets of every bucket's partial
   sums at level l: a bucket of m points has ceil(m / 2^l) there.
3. kernel K4 (csrc/msm_u8.cu, wrapper `scan_msm`): one launch of
   batch-affine adds a tree level, in which partials 2j and 2j + 1 of a
   bucket join (an odd last one is carried over) and each block shares one
   inversion among its adds (Montgomery's trick); the last level writes
   XYZZ. This takes the place of the TPU kernel's lane scan and its tails.
4. K3's reduction (csrc/curve.cuh): the pairwise XYZZ merge of each bucket's
   remaining partials, the suffix fold sum_{j>=1} sum_{d>=j} B_d = sum_d d
   B_d per window (`_suffix_fold`) and the window ladder: K4 returns the MSM
   as one XYZZ point on the device.

`lanes` is the chunk geometry of step 3: a level of A adds runs on at most
`lanes` threads (LANES by default: one wave of one 512-thread block an SM
on an H100), each with chunk = ceil(A / lanes) of them. Level
0 always runs (it gathers the points); a later level runs while its chunk
holds at least MIN_CHUNK adds and some bucket still has two partials, and
then the XYZZ merge takes over. A small `lanes` runs every level down to one
partial a bucket, which is how the CPU tests reach every branch.

`plain_scan_msm` is the plain version: the same levels, each an affine add
of every pair written out with the plain field functions and one batch
inversion (`plain_batch_inv`) of the level's denominators (how the
inversions are grouped changes no value: an affine sum is unique), then the
pairwise tree of `curve.run_sums` over what is left of each bucket and K3's
plain reduction (`msm.plain_reduce`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..utils import spans
from . import curve
from .field import fq_ops
from . import msm
from .msm import (
    merge_passes,
    merge_plan,
    plain_reduce,
    reduce_geometry,
    reduce_scratch,
    window_groups,
)

FQ = fq_ops()
WINDOW_BITS = 8
WINDOWS = 32             # 256-bit scalars: two 8-bit windows per 16-bit limb
BUCKETS = 1 << WINDOW_BITS
LEVEL_BLOCK = 512        # threads of a K4 level block (csrc/msm_u8.cu)
LANES = 1 << 16          # most threads one affine level runs on
MIN_CHUNK = 4            # fewest adds a thread for a level past the first
PLAIN_ITEMS = 1 << 22    # adds the plain version computes at once
# device bytes a (window, point) pair takes in one MSM: the measured peak of
# one msm_device_point over its 32 N pairs was 82 B a pair at 2^22 and 2^24
# on an H100 (scripts/reckon_1kb.py), most of it the level buffers (48 B and
# 24 B a pair) and the sort
PAIR_BYTES = 82
KINDS = ("copy", "add", "dbl", "cancel")


def window_digits(digits16: torch.Tensor, w0: int = 0,
                  w1: int = WINDOWS) -> torch.Tensor:
    """[n, 16] 16-bit limbs -> [w1 - w0, n] uint8 digits of windows w0 ..
    w1; window 2l + h is bits [16 l + 8 h, 16 l + 8 h + 8) of the scalar."""
    if digits16.dim() != 2 or digits16.shape[1] != WINDOWS // 2:
        raise ValueError(f"digits must be [n, 16] 16-bit limbs, got "
                         f"{tuple(digits16.shape)}")
    return torch.stack([(digits16[:, w // 2].to(torch.int32)
                         >> (8 * (w % 2))) & 0xFF for w in range(w0, w1)]
                       ).to(torch.uint8)


@dataclass
class Landing:
    """One MSM's sorted pairs and the geometry of its tree levels."""

    idx: torch.Tensor         # [P] int32 point of each pair, (window, digit)
    first: torch.Tensor       # [levels + 1, W*B + 1] int64 partial offsets
    lanes: int
    levels: int               # affine levels K4 runs
    geometry: np.ndarray      # [levels, 3] int64 (adds, chunk, threads)
    merge_passes: int         # XYZZ merge levels after the affine ones
    merge_prefix: torch.Tensor  # [merge_passes, W*B + 1] int64 (merge_plan)
    w0: int = 0               # the group's windows: w0 .. w0 + windows
    windows: int = WINDOWS


def level_geometry(items: int, lanes: int):
    """(chunk, threads) of a level of `items` adds on at most `lanes`
    threads: threads a multiple of LEVEL_BLOCK, threads * chunk >= items."""
    chunk = -(-items // lanes)
    blocks = -(-items // (chunk * LEVEL_BLOCK))
    return chunk, blocks * LEVEL_BLOCK


def land(digits16: torch.Tensor, lanes: Optional[int] = None,
         w0: int = 0, w1: int = WINDOWS) -> Landing:
    """Window digits, the per-window sort and the tree levels' offsets of
    windows w0 .. w1 (bucket (w - w0) * 256 + d - 1)."""
    n = digits16.shape[0]
    lanes = lanes or LANES
    if lanes < 1:
        raise ValueError(f"lanes must be positive, got {lanes}")
    if not 0 <= w0 < w1 <= WINDOWS:
        raise ValueError(f"bad window group {w0} .. {w1}")
    dev = digits16.device
    windows = w1 - w0
    nb = windows * BUCKETS
    ds, order = torch.sort(window_digits(digits16, w0, w1), dim=1,
                           stable=True)
    with spans.wait("k4_nonzero_digits"):
        idx = order[ds > 0].to(torch.int32)
    del order
    # where each nonzero digit's run starts in the sorted rows, then the
    # run lengths: bucket w * B + d - 1 holds m[w, d - 1] pairs
    digits = torch.arange(1, BUCKETS, dtype=torch.uint8, device=dev)
    starts = torch.searchsorted(ds, digits.expand(windows, -1).contiguous())
    del ds
    m = torch.zeros((windows, BUCKETS), dtype=torch.int64, device=dev)
    m[:, :-1] = torch.diff(starts, dim=1, append=torch.full(
        (windows, 1), n, dtype=torch.int64, device=dev))
    m = m.reshape(-1)
    # partials of every bucket at each level, up to one a bucket (m <= n)
    top_level = max(1, (n - 1).bit_length())
    step = 2 ** torch.arange(top_level + 1, device=dev)[:, None]
    per = (m[None] + step - 1) // step
    with spans.wait("k4_level_sizes", readback=16 * (top_level + 1)):
        tot, most = torch.stack([per.sum(1), per.max(1).values]).tolist()
    levels = 1 if tot[0] else 0
    while (levels < top_level and most[levels] > 1
           and -(-tot[levels + 1] // lanes) >= MIN_CHUNK):
        levels += 1
    geometry = np.array([(tot[l + 1], *level_geometry(tot[l + 1], lanes))
                         for l in range(levels)], np.int64).reshape(-1, 3)
    first = torch.zeros((levels + 1, nb + 1), dtype=torch.int64, device=dev)
    first[:, 1:] = torch.cumsum(per[:levels + 1], 1)
    passes = merge_passes(most[levels])
    return Landing(idx=idx, first=first, lanes=lanes, levels=levels,
                   geometry=geometry, merge_passes=passes,
                   merge_prefix=merge_plan(first[levels], passes), w0=w0,
                   windows=windows)


# -- K4 and its plain version ---------------------------------------------------


def scan_msm(points: torch.Tensor, plan: Landing,
             wsums: Optional[torch.Tensor] = None, ladder: bool = True):
    """K4 wrapper over the landing of one group of windows: their window
    sums S_w = sum_d d B_w,d go to rows plan.w0 .. plan.w0 + plan.windows
    of `wsums` ([32, 4, 12] XYZZ, the whole MSM's; made here when None),
    and with `ladder` the MSM sum_w 2^(8 w) S_w over all 32 rows follows.
    Returns (the MSM as one XYZZ point [4, 12], or None without `ladder`;
    wsums), Montgomery Fq. Plain version on CPU tensors, the kernel on
    CUDA."""
    if points.dtype != torch.int32 or points.dim() != 3 or \
            points.shape[1:] != (2, FQ.L):
        raise ValueError(f"points must be [N, 2, 12] int32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if wsums is None:
        wsums = torch.zeros((WINDOWS, 4, FQ.L), dtype=torch.int32,
                            device=points.device)
    if wsums.shape != (WINDOWS, 4, FQ.L) or wsums.device != points.device \
            or not wsums.is_contiguous():
        raise ValueError(f"bad window sums {tuple(wsums.shape)} on "
                         f"{wsums.device}")
    if points.device.type == "cpu":
        return plain_scan_msm(points, plan, wsums=wsums, ladder=ladder)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    kernels.check_device(points)
    for t, dt in ((plan.idx, torch.int32), (plan.first, torch.int64),
                  (plan.merge_prefix, torch.int64)):
        if t.dtype != dt or t.device != points.device or not t.is_contiguous():
            raise ValueError(f"bad landing tensor {t.dtype} on {t.device}")
    geo = plan.geometry
    if geo.dtype != np.int64 or geo.shape != (plan.levels, 3) or \
            not geo.flags.c_contiguous:
        raise ValueError(f"bad level geometry {geo.shape} {geo.dtype}")
    if plan.idx.numel():
        with spans.wait("k4_index_check", readback=4):
            top = int(plan.idx.max())
        if top >= points.shape[0]:
            raise ValueError("point index out of range")
    points = points.contiguous()
    dev = points.device
    items = geo[:, 0].tolist()

    def rows(n: int, words: int) -> torch.Tensor:
        return torch.empty((max(1, n), words, FQ.L), dtype=torch.int32,
                           device=dev)

    # levels 0, 2, ... write buf0 and 1, 3, ... buf1, the last `partial`
    buf0 = rows(items[0] if plan.levels > 1 else 0, 2)
    buf1 = rows(items[1] if plan.levels > 2 else 0, 2)
    partial = rows(items[-1] if items else 0, 4)
    slice_log, block_log = reduce_geometry(BUCKETS)
    # block_sums takes the 16 window pairs of the last group's ladder
    block_sums, counters, out = reduce_scratch(plan.windows, BUCKETS, dev,
                                               WINDOWS // 2)
    kernels.msm_u8(points.data_ptr(), plan.idx.data_ptr(),
                   plan.first.data_ptr(), plan.windows, plan.levels,
                   geo.ctypes.data, buf0.data_ptr(), buf1.data_ptr(),
                   partial.data_ptr(), plan.merge_prefix.data_ptr(),
                   plan.merge_passes, slice_log, block_log,
                   block_sums.data_ptr(), wsums[plan.w0].data_ptr(),
                   counters.data_ptr(), wsums.data_ptr(),
                   WINDOWS if ladder else 0, out.data_ptr())
    return (out if ladder else None), wsums


def _plain_level(src: torch.Tensor, idx: Optional[torch.Tensor],
                 first_in: torch.Tensor, first_out: torch.Tensor,
                 stats: Optional[dict]) -> torch.Tensor:
    """One tree level of K4 on the plain field functions: [items, 2, 12]
    affine partials from the level's inputs (src through idx at level 0)."""
    dev = src.device
    items = int(first_out[-1])
    out = torch.empty((items, 2, FQ.L), dtype=torch.int32, device=dev)
    one = FQ.const("one", dev)
    for a in range(0, items, PLAIN_ITEMS):
        v = torch.arange(a, min(items, a + PLAIN_ITEMS), device=dev)
        b = torch.searchsorted(first_out, v, right=True) - 1
        s = first_in[b] + 2 * (v - first_out[b])
        pair = s + 1 < first_in[b + 1]
        s2 = torch.where(pair, s + 1, s)
        p1 = src[idx[s] if idx is not None else s]
        p2 = src[idx[s2] if idx is not None else s2]
        x1, y1, x2, y2 = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
        fin1 = ~(FQ.is_zero(x1) & FQ.is_zero(y1))
        fin2 = pair & ~(FQ.is_zero(x2) & FQ.is_zero(y2))
        dx = FQ.plain_sub(x2, x1)
        same = fin1 & fin2 & FQ.is_zero(dx)
        add = fin1 & fin2 & ~same
        dbl = same & (y1 == y2).all(-1) & ~FQ.is_zero(y1)
        cancel = same & ~dbl
        sq = FQ.plain_mul(x1, x1)
        den = FQ.select(add, dx, FQ.select(dbl, FQ.plain_add(y1, y1),
                                           one.expand_as(x1)))
        num = FQ.select(add, FQ.plain_sub(y2, y1),
                        FQ.plain_add(FQ.plain_add(sq, sq), sq))
        lam = FQ.plain_mul(num, FQ.plain_batch_inv(den))
        x3 = FQ.plain_sub(FQ.plain_sub(FQ.plain_mul(lam, lam), x1), x2)
        y3 = FQ.plain_sub(FQ.plain_mul(lam, FQ.plain_sub(x1, x3)), y1)
        res = torch.where((pair & ~fin1)[:, None, None], p2, p1)
        res = torch.where(cancel[:, None, None], 0, res)
        out[a:a + v.shape[0]] = torch.where((add | dbl)[:, None, None],
                                            torch.stack([x3, y3], 1), res)
        if stats is not None:
            for k, mask in zip(KINDS, (~(add | dbl | cancel), add, dbl,
                                       cancel)):
                stats[k] = stats.get(k, 0) + int(mask.sum())
    return out


def plain_scan_msm(points: torch.Tensor, plan: Landing,
                   stats: Optional[dict] = None,
                   wsums: Optional[torch.Tensor] = None,
                   ladder: bool = True):
    """Plain version of K4: the affine levels (`_plain_level`), each
    bucket's remaining partials summed by `curve.run_sums`, and K3's plain
    reduction (window sums into rows plan.w0 .. of `wsums`; the ladder over
    all 32 with `ladder`). `stats`, if given, counts the levels' items by
    kind (copy, add, dbl, cancel)."""
    dev = points.device
    nb = plan.windows * BUCKETS
    part = points
    idx = plan.idx.to(torch.int64)
    for lvl in range(plan.levels):
        part = _plain_level(part, idx if lvl == 0 else None,
                            plan.first[lvl], plan.first[lvl + 1], stats)
    if plan.levels == 0:
        table = curve.infinity(nb, dev)
    else:
        x, y = part[:, 0], part[:, 1]
        inf = FQ.is_zero(x) & FQ.is_zero(y)
        z = FQ.select(inf, torch.zeros_like(x), FQ.const("one", dev)
                      .expand_as(x))
        last = plan.first[plan.levels]
        key = torch.repeat_interleave(torch.arange(nb, device=dev),
                                      last[1:] - last[:-1])
        table = curve.run_sums(key, (x, y, z), nb, affine=False)
    if wsums is None:
        wsums = torch.zeros((WINDOWS, 4, FQ.L), dtype=torch.int32,
                            device=dev)
    return plain_reduce(table, plan.windows, BUCKETS, WINDOW_BITS, wsums,
                        plan.w0, ladder)


def msm_parts(points: torch.Tensor, digits16: torch.Tensor,
              lanes: Optional[int] = None):
    """`scan_msm` of the first n points (n = number of digit rows), 8-bit
    windows, a group of windows at a time (`window_groups`): (MSM point
    [4, 12], window sums [32, 4, 12]), XYZZ."""
    n = digits16.shape[0]
    if points.shape[0] < n:
        raise ValueError(f"{points.shape[0]} points < {n} scalars")
    wsums = torch.empty((WINDOWS, 4, FQ.L), dtype=torch.int32,
                        device=points.device)
    for w0, w1 in window_groups(WINDOWS, n, PAIR_BYTES, msm.GROUP_BYTES):
        out, _ = scan_msm(points[:n], land(digits16, lanes, w0, w1), wsums,
                          ladder=w1 == WINDOWS)
    return out, wsums
