"""Host CPU milliseconds a proof costs: the thread CPU time of each
thread's outermost port spans (the request's root on the caller, each
`prove` on a pool thread), less that of the `wait.card` spans inside them
(a wait spins), over the proofs the traced stretch completed. Times
`proofs_per_s`, near 1,000 ms/s the interpreter is saturated."""

from zkbench import program_spans

SPANS = program_spans.HOOKS


def read(run):
    j = program_spans.joined(run)
    return None if j is None else j.per_proof_ms(j.host_cpu_s())
