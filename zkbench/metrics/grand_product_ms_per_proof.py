"""Device milliseconds a Plonk proof spends in its grand product: the
kernels launched inside the port's `plonk.grand_product` spans (the
permutation's numerators and denominators on H, their batch inversion and
the prefix product, `plonk/prover.py` round 2), on the trace's clock,
over the proofs the traced stretch completed. A port without the span
reads nothing."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def device_ms(run, kind: str):
    """Device ms a proof of the kernels launched inside the port's spans
    of `kind`, or None where the run has none."""
    j = program_spans.joined(run)
    if j is None or not j.proofs:
        return None
    found = j.trace.kernels_by_span(kind)
    if not found:
        return None
    return j.per_proof_ms(sum(k.end - k.start for _, ks in found
                              for k in ks))


def read(run):
    return device_ms(run, "plonk.grand_product")
