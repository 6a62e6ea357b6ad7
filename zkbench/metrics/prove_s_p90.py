"""The 90th percentile of every request's latency in the window: from the
call to its synchronized return, on the host clock."""

from zkbench.stats import percentile


def read(run):
    return percentile(run.latencies, 90) if run.latencies else None
