"""Host milliseconds a proof spends on KZG's hiding terms: the length of
the port's `host.hiding` spans (the host MSMs over the gamma powers in
`_commit_batch` and `_batch_open`, with `poly_div_linear`), on the trace's
clock, over the proofs the traced stretch completed. A Plonk proof's
commitments carry no hiding term (its masks are multiples of the
vanishing polynomial, drawn under `host.mask_draw`): there it reads 0."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    return None if j is None else j.per_proof_ms(j.host_s("host.hiding"))
