"""Device kernels the traced stretch launched, torch glue included, over
the proofs it completed: an exact count of the launches a proof costs."""


def read(run):
    tr = run.trace
    if tr is None or not tr.proofs or not tr.kernels:
        return None
    return len(tr.kernels) / tr.proofs
