"""The two readers of Plonk's rounds (`grand_product_ms_per_proof`,
`quotient_ms_per_proof`) by hand on a made-up trace: the kernels launched
inside the port's `plonk.grand_product` and `plonk.quotient` spans, and
nothing where the port has no such span (the parent of the change that
added them)."""

from types import SimpleNamespace

import pytest

from zkbench import program_spans
from zkbench.metrics import grand_product_ms_per_proof, quotient_ms_per_proof
from zkbench.trace import Kernel, Trace

OFF = 1000.0                        # trace us - host us
S = 1_000_000_000                   # ns a second


def record(name, rid, parent, t0, t1, proof=None):
    return SimpleNamespace(
        name=name, id=rid, parent=parent, request=1, proof=proof, tid=5,
        ident=50, t0=int(t0 * S), t1=int(t1 * S), c0=0, c1=0, attrs={})


def launch(i, ts, start, end):
    """A kernel launched at `ts` that runs from `start` to `end` (s)."""
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": ts * 1e6 + OFF, "dur": 5, "tid": 5,
             "args": {"correlation": i}},
            {"cat": "kernel", "name": f"k{i}", "ts": start * 1e6 + OFF,
             "dur": (end - start) * 1e6, "tid": 7,
             "args": {"correlation": i}}]


def made_up(records, proofs=2):
    """Two proofs; kernels 1-2 in the grand product of the first, 3 in
    its quotient, 4 in the second's quotient, 5 in no span of either."""
    evs = [{"cat": "user_annotation", "name": "zkb.call|0",
            "ts": 10.0e6 + OFF, "dur": 2.0e6, "tid": 5}]
    for r in records:
        evs.append({"cat": "user_annotation",
                    "name": f"zkaes.{r.name}|{r.id}", "ts": r.t0 / 1e3 + OFF,
                    "dur": (r.t1 - r.t0) / 1e3, "tid": 5})
    kernels = [(1, 10.11, 10.12, 10.15), (2, 10.13, 10.16, 10.18),
               (3, 10.31, 10.32, 10.42), (4, 11.31, 11.32, 11.37),
               (5, 10.50, 10.51, 10.61)]
    for i, ts, start, end in kernels:
        evs += launch(i, ts, start, end)
    trace = Trace(start=10.0, end=12.0, proofs=proofs,
                  kernels=[Kernel(f"k{i}", s, e, ts, 5)
                           for i, ts, s, e in kernels],
                  device=[(s, e) for _, _, s, e in kernels], spans={},
                  samples=[])
    return evs, trace


RECORDS = [
    record("prove", 1, None, 10.0, 10.9, proof=1),
    record("plonk.grand_product", 2, 1, 10.1, 10.2, proof=1),
    record("plonk.quotient", 3, 1, 10.3, 10.4, proof=1),
    record("prove", 4, None, 11.0, 11.9, proof=4),
    record("plonk.grand_product", 5, 4, 11.1, 11.2, proof=4),
    record("plonk.quotient", 6, 4, 11.3, 11.4, proof=4),
]


def install(monkeypatch, records):
    evs, trace = made_up(records)
    monkeypatch.setattr(program_spans, "_state", {
        "tracer": SimpleNamespace(calls={0: (10.0, 12.0)}),
        "records": records, "counters": {}, "events": evs, "joined": None})
    return SimpleNamespace(trace=trace)


def test_each_reader_sums_the_kernels_inside_its_spans(monkeypatch):
    run = install(monkeypatch, RECORDS)
    # (30 + 20) ms in the grand products, (100 + 50) ms in the quotients,
    # over two proofs; kernel 5 lies in neither
    assert grand_product_ms_per_proof.read(run) == pytest.approx(25.0)
    assert quotient_ms_per_proof.read(run) == pytest.approx(75.0)


def test_the_readers_read_nothing_without_the_ports_spans(monkeypatch):
    marlin = [r for r in RECORDS if r.name == "prove"]
    run = install(monkeypatch, marlin)
    assert grand_product_ms_per_proof.read(run) is None
    assert quotient_ms_per_proof.read(run) is None
    monkeypatch.setattr(program_spans, "_state", {
        "tracer": None, "records": None, "counters": None, "events": None,
        "joined": None})
    for mod in (grand_product_ms_per_proof, quotient_ms_per_proof):
        assert mod.read(SimpleNamespace(trace=None)) is None
