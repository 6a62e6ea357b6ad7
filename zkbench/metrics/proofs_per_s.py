"""Correct proofs completed over the window's wall time (host clock): a
call that starts inside the window is finished, and the window extends to
its end; a proof the reference refuses does not count."""


def read(run):
    return run.correct / run.window_s
