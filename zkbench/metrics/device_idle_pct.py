"""The share of the traced stretch in which no kernel or copy ran on the
device: one minus the union of every device interval over the stretch's
wall time (from the first traced call's start to the last one's end)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
