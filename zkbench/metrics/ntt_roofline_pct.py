"""The NTTs' share of their roofline: the least time the card could take
for the traced stretch's transforms, over the device time of the kernels
launched inside spans around `NTTEngine`'s `ntt`, `intt`, `ntt_rows` and
`intt_rows` (K2's passes and their glue).

A transform of `rows` rows of n Fr elements (32 bytes each) reads each
input byte once and writes each output byte once, 2 * rows * n * 32
bytes, and its butterflies take rows * n / 2 * log2(n) Fr products,
`FR_PRODUCT` multiply-adds each (`zkbench/peaks.py`); the least time is
the larger of the two over the card's rates. Only spans with a kernel
attributed to them count, in the least time as in the device time, so a
span whose launches were lost cannot raise the share.
"""

from zkbench.peaks import FR_PRODUCT, least_seconds

ENGINE = "aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt:NTTEngine"


def size(args, kwargs) -> str:
    """`method(self, x)`: "n x rows"."""
    engine, x = args[0], args[1]
    return f"{engine.n}x{x.shape[0] if x.dim() == 3 else 1}"


SPANS = tuple(("ntt", ENGINE, m, size)
              for m in ("ntt", "intt", "ntt_rows", "intt_rows"))


def least_ntt_seconds(n: int, rows: int) -> float:
    log_n = n.bit_length() - 1
    return least_seconds(2 * rows * n * 32,
                         rows * (n // 2) * log_n * FR_PRODUCT)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    found = [(sp, ks) for sp, ks in tr.kernels_by_span("ntt") if ks]
    busy = sum(k.end - k.start for _, ks in found for k in ks)
    if busy <= 0:
        return None
    least = sum(least_ntt_seconds(*map(int, sp.desc.split("x")))
                for sp, _ in found)
    return 100.0 * least / busy
