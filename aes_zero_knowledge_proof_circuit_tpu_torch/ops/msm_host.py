"""Host-side Pippenger multi-scalar multiplication (test oracle).

Oracle for msm_jax.py (the TPU Pippenger kernel, SURVEY.md §7 step 5) and the
MSM used for small host-scale proofs in tests. Mirrors ark-ec's
VariableBaseMSM at the reference's KZG commit call sites (SURVEY.md §2b).
"""

from __future__ import annotations

from typing import List, Sequence

from .curve_host import AffinePoint, g1_infinity
from .field_params import R_MOD


def msm(points: Sequence[AffinePoint], scalars: Sequence[int],
        window_bits: int | None = None) -> AffinePoint:
    """sum_i scalars[i] * points[i] via windowed bucket (Pippenger) method.

    Dispatches to the native C++ library (native/zkhost.cpp) when it is
    available — the host-runtime analog of ark-ec's parallel Rust MSM — and
    otherwise runs the pure-Python Pippenger below (itself the bit-exactness
    oracle for both the native library and the device kernel)."""
    assert len(points) == len(scalars)
    if not points:
        return g1_infinity()
    scalars = [s % R_MOD for s in scalars]
    if len(points) > 8:  # ctypes packing overhead beats Python above ~8 pts
        from ..utils import native

        fast = native.g1_msm(points, scalars)
        if fast is not None:
            return fast
    return _msm_python(points, scalars, window_bits)


def _msm_python(points: Sequence[AffinePoint], scalars: Sequence[int],
                window_bits: int | None = None) -> AffinePoint:
    if window_bits is None:
        # bucket-fold work is ~2^c adds/window regardless of n: size the
        # window to n (a fixed c=8 made a 5-point MSM cost 8k affine adds,
        # each a Fermat inversion — the dominant cost of toy-scale proofs)
        n = len(points)
        window_bits = 8 if n >= 256 else (4 if n >= 16 else 2)
    max_bits = R_MOD.bit_length()
    num_windows = (max_bits + window_bits - 1) // window_bits
    window_sums: List[AffinePoint] = []
    mask = (1 << window_bits) - 1
    for w in range(num_windows):
        shift = w * window_bits
        buckets: dict[int, AffinePoint] = {}
        for p, s in zip(points, scalars):
            d = (s >> shift) & mask
            if d == 0 or p.inf:
                continue
            buckets[d] = buckets[d].add(p) if d in buckets else p
        # sum_d d * B_d via running suffix sums; digits above the largest
        # occupied bucket contribute nothing (running is infinity there)
        running = g1_infinity()
        acc = g1_infinity()
        for d in range(max(buckets, default=0), 0, -1):
            if d in buckets:
                running = running.add(buckets[d])
            acc = acc.add(running)
        window_sums.append(acc)
    # combine windows: result = sum_w 2^(w*c) S_w, horner from the top
    result = g1_infinity()
    for s_w in reversed(window_sums):
        for _ in range(window_bits):
            result = result.double()
        result = result.add(s_w)
    return result


def msm_naive(points: Sequence[AffinePoint], scalars: Sequence[int]) -> AffinePoint:
    """Reference double-and-add sum (for tiny cross-checks)."""
    acc = g1_infinity()
    for p, s in zip(points, scalars):
        acc = acc.add(p.mul_scalar(s % R_MOD))
    return acc
