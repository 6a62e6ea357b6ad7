"""The 8-bit bucket-scan MSM stages — counterpart of ops/msm_pallas.py.

    points   [N, 2, 12] int32: affine (x, y) in Montgomery Fq limbs
             (x = y = 0 marks infinity), from `points_from_packed`
    digits16 [n, 16] int32: standard-form scalars as 16-bit limbs

Stages, as in the JAX module, for all 32 windows at once:

1. `window_digits`: 32 unsigned 8-bit windows taken from the 16 limbs,
   least significant first (`_window_digits`).
2. `land`: the per-window sort by digit and the column-major landing: lane
   j of a window owns the contiguous sorted run [j*steps, (j+1)*steps),
   across bucket boundaries, stored as [W, steps, lanes] so that the lanes
   of one step lie side by side. n is padded to lanes*steps with zero digits
   (never added). Here each lane scans STEPS pairs, so the lanes fill the
   card; the TPU kernel uses 128 lanes.
3. the bucket scan in lanes, kernel K4 (csrc/msm_u8.cu, wrapper
   `scan_window_sums`): every lane closes each (lane, bucket) run with one
   tail. Digit 0 is the dump: its pairs are never added and leave no tail.
   The tails go to the slots `land` counted (`lane_base`), in (window,
   digit) order, which takes the place of the scatter into per-lane bucket
   tables.
4. the lane merge: each bucket's tails summed with complete adds (tails of
   one bucket from adjacent lanes can be equal or opposite points).
5. the suffix fold sum_{j>=1} sum_{d>=j} B_d = sum_d d B_d per window
   (`_suffix_fold`), as the chunked running sums of the K3 reduction.

`plain_scan_window_sums` is the plain version of stages 3-5, built from
the curve formulas of ops/curve.py: each (lane, bucket) run and each
bucket is summed by a pairwise tree instead of a sequential scan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import kernels
from . import curve
from .field import fq_ops
from .msm import _chunk, plain_fold

FQ = fq_ops()
WINDOW_BITS = 8
WINDOWS = 32             # 256-bit scalars: two 8-bit windows per 16-bit limb
BUCKETS = 1 << WINDOW_BITS
STEPS = 256              # sorted pairs one K4 thread scans: its lane's slice
PLAIN_PAIRS = 1 << 23    # sorted pairs the plain version sums in one pass


def window_digits(digits16: torch.Tensor) -> torch.Tensor:
    """[n, 16] 16-bit limbs -> [32, n] uint8 window digits; window 2l + h
    is bits [16 l + 8 h, 16 l + 8 h + 8) of the scalar."""
    if digits16.dim() != 2 or digits16.shape[1] != WINDOWS // 2:
        raise ValueError(f"digits must be [n, 16] 16-bit limbs, got "
                         f"{tuple(digits16.shape)}")
    d = digits16.to(torch.int32)
    both = torch.stack([d & 0xFF, (d >> 8) & 0xFF], dim=-1)
    return both.reshape(d.shape[0], WINDOWS).T.to(torch.uint8).contiguous()


@dataclass
class Landing:
    """One MSM's sorted pairs in the column-major landing, with the tail
    bookkeeping the scan kernel needs."""

    order: torch.Tensor       # [W, steps, lanes] int32 point index
    digits: torch.Tensor      # [W, steps, lanes] uint8 sorted digit
    lanes: int
    steps: int
    lane_base: torch.Tensor   # [W*lanes + 1] int64 first tail slot per lane
    first: torch.Tensor       # [W*B + 1] int64 tails of bucket w*B + d - 1
    n_tails: int


def _tail_mask(lane_digits: torch.Tensor) -> torch.Tensor:
    """[W, lanes, steps] sorted digits -> the pairs that close a (lane,
    bucket) run of a nonzero digit."""
    last = torch.ones_like(lane_digits, dtype=torch.bool)
    last[..., :-1] = lane_digits[..., 1:] != lane_digits[..., :-1]
    return last & (lane_digits > 0)


def land(digits16: torch.Tensor, lanes: Optional[int] = None) -> Landing:
    """Window digits, the per-window sort and the column-major landing."""
    n = digits16.shape[0]
    lanes = lanes or max(1, -(-n // STEPS))
    steps = max(1, -(-n // lanes))
    dev = digits16.device
    dw = window_digits(digits16)
    pad = lanes * steps - n
    if pad:
        dw = torch.cat([dw, torch.zeros((WINDOWS, pad), dtype=torch.uint8,
                                        device=dev)], dim=1)
    ds, order = torch.sort(dw, dim=1, stable=True)
    # padding pairs carry digit 0 and are never read; keep their index valid
    order = torch.where(order < n, order, 0).to(torch.int32)
    lane_digits = ds.view(WINDOWS, lanes, steps)
    tail = _tail_mask(lane_digits)
    lane_base = torch.zeros(WINDOWS * lanes + 1, dtype=torch.int64,
                            device=dev)
    lane_base[1:] = torch.cumsum(tail.sum(-1).reshape(-1), 0)
    win = torch.arange(WINDOWS, device=dev).view(WINDOWS, 1, 1)
    tail_key = (win * BUCKETS + lane_digits.to(torch.int64) - 1)[tail]
    first = torch.zeros(WINDOWS * BUCKETS + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(
        torch.bincount(tail_key, minlength=WINDOWS * BUCKETS), 0)
    column_major = lambda t: t.view(WINDOWS, lanes, steps).transpose(
        1, 2).contiguous()
    return Landing(order=column_major(order), digits=column_major(ds),
                   lanes=lanes, steps=steps, lane_base=lane_base, first=first,
                   n_tails=int(lane_base[-1]))


# -- K4 and its plain version ---------------------------------------------------


def scan_window_sums(points: torch.Tensor, plan: Landing) -> torch.Tensor:
    """K4 wrapper: [32, 3, 12] Jacobian window sums S_w = sum_d d B_w,d
    (Montgomery Fq). Plain version on CPU tensors, the kernel on CUDA."""
    if points.dtype != torch.int32 or points.dim() != 3 or \
            points.shape[1:] != (2, FQ.L):
        raise ValueError(f"points must be [N, 2, 12] int32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if points.device.type == "cpu":
        return plain_scan_window_sums(points, plan)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    for t, dt in ((plan.order, torch.int32), (plan.digits, torch.uint8),
                  (plan.lane_base, torch.int64), (plan.first, torch.int64)):
        if t.dtype != dt or t.device != points.device or not t.is_contiguous():
            raise ValueError(f"bad landing tensor {t.dtype} on {t.device}")
    if int(plan.order.max()) >= points.shape[0]:
        raise ValueError("point index out of range")
    points = points.contiguous()
    dev = points.device
    chunk = _chunk(BUCKETS)
    tails = torch.empty((max(1, plan.n_tails), 3, FQ.L), dtype=torch.int32,
                        device=dev)
    bucket_scratch = torch.empty((WINDOWS * BUCKETS, 3, FQ.L),
                                 dtype=torch.int32, device=dev)
    chunk_scratch = torch.empty((WINDOWS * (BUCKETS // chunk), 2, 3, FQ.L),
                                dtype=torch.int32, device=dev)
    out = torch.empty((WINDOWS, 3, FQ.L), dtype=torch.int32, device=dev)
    kernels.msm_u8(points.data_ptr(), plan.order.data_ptr(),
                   plan.digits.data_ptr(), WINDOWS, plan.lanes, plan.steps,
                   plan.lane_base.data_ptr(), plan.first.data_ptr(), chunk,
                   chunk.bit_length() - 1, tails.data_ptr(),
                   bucket_scratch.data_ptr(), chunk_scratch.data_ptr(),
                   out.data_ptr())
    return out


def plain_scan_window_sums(points: torch.Tensor, plan: Landing
                           ) -> torch.Tensor:
    """Plain version of K4: the tails of every (lane, bucket) run, the
    bucket totals over `plan.first`, and the suffix fold. The tails are
    summed for a few windows at a time (at most PLAIN_PAIRS pairs), which
    bounds the memory of the plain field products."""
    dev = points.device
    lane_major = lambda t: t.transpose(1, 2).reshape(WINDOWS, -1)
    digits = lane_major(plan.digits)
    order = lane_major(plan.order).to(torch.int64)
    tail = _tail_mask(digits.view(WINDOWS, plan.lanes, plan.steps)).reshape(
        WINDOWS, -1)
    tails = curve.infinity(plan.n_tails, dev)
    group = max(1, PLAIN_PAIRS // digits.shape[1])
    for w0 in range(0, WINDOWS, group):
        w1 = min(WINDOWS, w0 + group)
        d, t = digits[w0:w1].reshape(-1), tail[w0:w1].reshape(-1)
        lo = int(plan.lane_base[w0 * plan.lanes])
        hi = int(plan.lane_base[w1 * plan.lanes])
        # each pair's run ends at the next tail: its slot is the tails
        # before it
        slot = torch.cumsum(t.to(torch.int64), 0) - t.to(torch.int64)
        pts = points[order[w0:w1].reshape(-1)]
        x, y = pts[:, 0], pts[:, 1]
        keep = (d > 0) & ~(FQ.is_zero(x) & FQ.is_zero(y))
        one = FQ.const("one", dev).expand(int(keep.sum()), FQ.L)
        part = curve.run_sums(slot[keep], (x[keep], y[keep], one), hi - lo,
                              affine=True)
        for a, b in zip(tails, part):
            a[lo:hi] = b
    counts = plan.first[1:] - plan.first[:-1]
    bucket = torch.repeat_interleave(
        torch.arange(WINDOWS * BUCKETS, device=dev), counts)
    table = curve.run_sums(bucket, tails, WINDOWS * BUCKETS, affine=False)
    return plain_fold(table, WINDOWS, BUCKETS)


def window_sums(points: torch.Tensor, digits16: torch.Tensor,
                lanes: Optional[int] = None) -> torch.Tensor:
    """[32, 3, 12] Jacobian window sums of the first n points (n = number
    of digit rows), 8-bit windows."""
    n = digits16.shape[0]
    if points.shape[0] < n:
        raise ValueError(f"{points.shape[0]} points < {n} scalars")
    return scan_window_sums(points[:n], land(digits16, lanes))
