"""Host milliseconds a proof spends blocked on the card: the length of the
port's `wait.card` spans (a copy to or from the host, or a stream's end),
on the trace's clock, over the proofs the traced stretch completed."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    return None if j is None else j.per_proof_ms(j.host_s("wait.card"))
