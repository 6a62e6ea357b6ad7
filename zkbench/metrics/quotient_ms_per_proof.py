"""Device milliseconds a Plonk proof spends on its quotient: the kernels
launched inside the port's `plonk.quotient` spans (the five transforms to
the 4n coset, the gate, permutation and start terms there, the division
by the vanishing polynomial, the transform back and the split in three,
`plonk/prover.py` round 3), on the trace's clock, over the proofs the
traced stretch completed. A port without the span reads nothing."""

from zkbench import program_spans
from zkbench.metrics.grand_product_ms_per_proof import device_ms

SPANS = program_spans.HOOKS


def read(run):
    return device_ms(run, "plonk.quotient")
