"""Host milliseconds a proof spends drawing its zero-knowledge masks: the
length of the port's `host.mask_draw` spans (`_rand_mont`'s 2n + 1 field
elements and the six r_w, r_a, r_b draws), on the trace's clock, over the
proofs the traced stretch completed. For Plonk the port's span is to
wrap its blinding draws (two scalars for each wire, three for z, two for
the quotient)."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    return None if j is None else j.per_proof_ms(j.host_s("host.mask_draw"))
