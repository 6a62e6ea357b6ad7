"""Times a proof blocks the host on the card: the port's `card_waits`
counter (one a `wait.card` span) over the proofs the traced stretch
completed; an exact count."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    if j is None or not j.proofs:
        return None
    return j.counters.get("card_waits", 0) / j.proofs
