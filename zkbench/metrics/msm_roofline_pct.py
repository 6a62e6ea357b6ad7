"""The MSMs' share of their roofline: the least time the card could take
for the traced stretch's MSMs, over the device time of the kernels
launched inside their spans (as `msm_ms_per_proof` counts it).

The least time of an MSM of N points and Fr scalars is counted from N
and the scalar width alone, whatever engine runs it:

- point additions: the fewest over window widths c of a bucket method,
  ceil(b / c) windows each adding every point into a bucket once and
  summing 2^(c-1) signed-digit buckets in 2^c more adds: ceil(b / c) *
  (N + 2^c), with b = 253 bits over N points, or with the curve's
  endomorphism b = 127 bits over 2N points, whichever is fewer;
- each addition at 6 Fq products, a batch-affine addition's (the
  slope's product, its share of a batched inversion's three, the square
  and the product of the new y), `FQ_PRODUCT` multiply-adds each;
- bytes: each affine point (96 bytes) and scalar (32 bytes) read once.

The least time is the larger of the multiply-adds over `IMAD_S` and the
bytes over `HBM_BYTES_S` (`zkbench/peaks.py`), summed over the MSMs of
each span ("N", or "N1+N2+..." for a batch). A better algorithm does
fewer additions than a bucket method's, none fewer than this count's, so
the share stays under 100 %. Only spans with a kernel attributed to them
count, in the least time as in the device time.
"""

from zkbench.metrics.msm_ms_per_proof import SPANS  # noqa: F401
from zkbench.peaks import FQ_PRODUCT, least_seconds

SCALAR_BITS = 253
ENDO_BITS = 127
ADD_PRODUCTS = 6
POINT_BYTES = 96
SCALAR_BYTES = 32


def least_adds(n: int) -> int:
    best = None
    for bits, points in ((SCALAR_BITS, n), (ENDO_BITS, 2 * n)):
        for c in range(1, 33):
            adds = -(-bits // c) * (points + (1 << c))
            best = adds if best is None else min(best, adds)
    return best


def least_msm_seconds(n: int) -> float:
    return least_seconds(n * (POINT_BYTES + SCALAR_BYTES),
                         least_adds(n) * ADD_PRODUCTS * FQ_PRODUCT)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    found = [(sp, ks) for sp, ks in tr.kernels_by_span("msm") if ks]
    busy = sum(k.end - k.start for _, ks in found for k in ks)
    if busy <= 0:
        return None
    return 100.0 * sum(least_msm_seconds(int(n))
                       for sp, _ in found for n in sp.desc.split("+")) / busy
