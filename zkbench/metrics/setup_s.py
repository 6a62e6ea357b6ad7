"""Process start to the window's start, on the host clock: the port's
import, the kernels' build or load, the template, the SRS, the index,
the prover, and one warm call of the cell's own shape."""


def read(run):
    return run.setup_s
