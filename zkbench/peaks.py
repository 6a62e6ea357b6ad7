"""The card's peak rates, frozen here (copied from the port's
`chip_smoke.py`): one NVIDIA H100 SXM at its 700 W limit.

- HBM bytes a second: 3.35 TB/s (NVIDIA's data sheet).
- 32-bit integer multiply-adds a second: 64 a clock on each of the 132
  SMs at the 1.98 GHz boost clock (CUDA C++ Programming Guide,
  arithmetic instructions, compute capability 9.0).
- Multiply-adds of one Montgomery product over L 32-bit limbs: 2 (the low
  and high halves) for each of the L^2 limb products of a * b and of
  m * p: Fr (8 limbs) 256, Fq (12 limbs) 576.
"""

HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
FR_PRODUCT = 2 * 2 * 8 * 8
FQ_PRODUCT = 2 * 2 * 12 * 12


def least_seconds(nbytes: float, imads: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the multiply-adds over the IMAD rate."""
    return max(nbytes / HBM_BYTES_S, imads / IMAD_S)
