"""The share of the traced stretch with two `TorchProver.prove` calls
open at once, from spans around them: how much of the time the batch's
pipeline keeps two proofs in flight. (Overlap is not concurrency: the
two proofs' Python glue still takes the interpreter lock in turn.)"""

PROVER = "aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover:TorchProver"
SPANS = (("prove", PROVER, "prove", lambda args, kwargs: ""),)


def open_at_least(spans, k: int, start: float, end: float) -> float:
    """Seconds of [start, end] with k or more of the spans open."""
    inside = [s for s in spans if s.end > start and s.start < end]
    edges = sorted([(max(s.start, start), 1) for s in inside]
                   + [(min(s.end, end), -1) for s in inside])
    total, depth, last = 0.0, 0, start
    for t, step in edges:
        if depth >= k:
            total += max(0.0, t - last)
        depth += step
        last = t
    return total


def read(run):
    tr = run.trace
    if tr is None or not tr.spans.get("prove"):
        return None
    return 100.0 * open_at_least(tr.spans["prove"], 2, tr.start,
                                 tr.end) / tr.window_s
