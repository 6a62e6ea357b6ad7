"""Milliseconds a proof spends in the witness fill: from the start of each
`witness.fill` span of the port (`WitnessEvaluator.evaluate_batch`) to the
end of the last kernel launched inside it (the span's own end where it
launched none), on the trace's clock, over the proofs the traced stretch
completed; a batch's one fill counts once for its proofs. For Plonk the
port's span is to wrap the witness (`aes_map.assign` and
`wire_columns`) and its upload; without one a Plonk cell reads
nothing."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    if j is None:
        return None
    found = j.trace.kernels_by_span("witness.fill")
    if not found:
        return None
    return j.per_proof_ms(sum(
        (max(k.end for k in ks) if ks else sp.end) - sp.start
        for sp, ks in found))
