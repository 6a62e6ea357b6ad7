"""One module a metric, found by the metric's name in BENCHMARK.json.

Each module has `read(run)`, which returns the metric's value or None
where the run has nothing it can read (the harness then leaves the
metric out of the result line), and, where the metric needs spans around
calls into the port, `SPANS`: (kind, "module:Class", method, describe)
for the tracer to wrap. `run` is `zkbench.run.Run`; a traced run's
`run.trace` is `zkbench.trace.Trace`. `zkbench/peaks.py` holds the card's peak
rates that the roofline shares divide by.
"""
