"""The port's own spans in a traced run (`zkbench/program_spans.py`): put
on the trace's clock by their annotations and read by the six metrics
that read them, by hand on a made-up trace and in a whole traced run of
the toy cell on the CPU profiler."""

import dataclasses
from types import SimpleNamespace

import pytest

from zkbench import program_spans, run
from zkbench.metrics import (card_wait_ms_per_proof, card_waits_per_proof,
                             hiding_ms_per_proof, host_cpu_ms_per_proof,
                             mask_draw_ms_per_proof, witness_ms_per_proof)
from zkbench.tests import toy
from zkbench.trace import Kernel, Trace

READERS = {"witness_ms_per_proof": witness_ms_per_proof,
           "hiding_ms_per_proof": hiding_ms_per_proof,
           "mask_draw_ms_per_proof": mask_draw_ms_per_proof,
           "host_cpu_ms_per_proof": host_cpu_ms_per_proof,
           "card_wait_ms_per_proof": card_wait_ms_per_proof,
           "card_waits_per_proof": card_waits_per_proof}
OFF = 1000.0                        # trace us - host us
S = 1_000_000_000                   # ns a second


def record(name, rid, parent, t0, t1, cpu, proof=None, tid=5, **attrs):
    """A span record as the port's facility keeps it; its host times are
    off by 1 ms from its annotation's, which the join must replace."""
    return SimpleNamespace(
        name=name, id=rid, parent=parent, request=1, proof=proof, tid=tid,
        ident=50, t0=int((t0 + 1e-3) * S), t1=int((t1 + 1e-3) * S), c0=0,
        c1=int(cpu * S), attrs=attrs)


RECORDS = [
    record("api.encrypt", 1, None, 10.0, 10.9, 0.5, messages=1),
    record("witness.fill", 2, 1, 10.1, 10.2, 0.05, rows=1),
    record("prove", 3, 1, 10.2, 10.8, 0.4, proof=3),
    record("host.hiding", 4, 3, 10.3, 10.35, 0.05, proof=3),
    record("host.mask_draw", 5, 3, 10.4, 10.42, 0.02, proof=3),
    record("wait.card", 6, 3, 10.5, 10.6, 0.05, proof=3, what="to_ints"),
]
COUNTERS = {"card_waits": 1, "readback_bytes": 32}


def events():
    out = [{"cat": "user_annotation", "name": "zkb.call|0",
            "ts": 10.0e6 + OFF, "dur": 0.9e6, "tid": 5}]
    for r in RECORDS:
        t0 = r.t0 / 1e3 - 1e3          # the annotation's: host - 1 ms
        out.append({"cat": "user_annotation",
                    "name": f"zkaes.{r.name}|{r.id}", "ts": t0 + OFF,
                    "dur": (r.t1 - r.t0) / 1e3, "tid": 5})
    out += [
        # a fill kernel launched at 10.15 that ends at 10.25
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10.15e6 + OFF, "dur": 5, "tid": 5, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "fill", "ts": 10.2e6 + OFF, "dur": 0.05e6,
         "tid": 7, "args": {"correlation": 1}},
        # the wait's synchronization
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 10.55e6 + OFF, "dur": 10, "tid": 5},
    ]
    return out


def made_up_trace(evs):
    kernels = [Kernel("fill", 10.2, 10.25, 10.15, 5)]
    return Trace(start=10.0, end=10.9, proofs=1, kernels=kernels,
                 device=[(10.2, 10.25)], spans={}, samples=[])


@pytest.fixture
def made_up(monkeypatch):
    evs = events()
    tracer = SimpleNamespace(calls={0: (10.0, 10.9)})
    monkeypatch.setattr(program_spans, "_state", {
        "tracer": tracer, "records": RECORDS, "counters": COUNTERS,
        "events": evs, "joined": None})
    return SimpleNamespace(trace=made_up_trace(evs))


def test_the_join_times_each_span_by_its_annotation(made_up):
    j = program_spans.joined(made_up)
    assert all(sp.exact for sp in j.spans)
    fill = j.trace.spans["witness.fill"][0]
    assert fill.start == pytest.approx(10.1) and fill.end == pytest.approx(
        10.2)
    assert [len(ks) for _, ks in j.trace.kernels_by_span("witness.fill")] \
        == [1]
    assert j.depth == {1: 0, 2: 1, 3: 1, 4: 2, 5: 2, 6: 2}
    assert program_spans.joined(made_up) is j       # computed once
    assert not list(made_up.trace.spans)            # the run's is untouched


def test_each_reader_reads_its_hand_worked_value(made_up):
    want = {"witness_ms_per_proof": 150.0,          # 10.1 to 10.25
            "hiding_ms_per_proof": 50.0,
            "mask_draw_ms_per_proof": 20.0,
            "host_cpu_ms_per_proof": 450.0,         # the root's less the wait
            "card_wait_ms_per_proof": 100.0,
            "card_waits_per_proof": 1.0}
    for name, mod in READERS.items():
        assert mod.read(made_up) == pytest.approx(want[name]), name


def test_idle_time_goes_to_the_deepest_span(made_up):
    idle = program_spans.idle_by_span(program_spans.joined(made_up))
    assert sum(idle.values()) == pytest.approx(0.9 - 0.05)
    assert idle["wait.card(to_ints)"] == pytest.approx(0.1)
    assert idle["host.hiding"] == pytest.approx(0.05)
    assert idle["witness.fill"] == pytest.approx(0.1)
    # before the fill, and after the prove
    assert idle["api.encrypt"] == pytest.approx(0.1 + 0.1)
    assert idle["prove"] == pytest.approx(0.6 - 0.05 - 0.02 - 0.1 - 0.05)


def test_readers_read_nothing_without_the_ports_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "_state", {
        "tracer": None, "records": None, "counters": None, "events": None,
        "joined": None})
    for mod in READERS.values():
        assert mod.read(SimpleNamespace(trace=None)) is None
        assert mod.read(SimpleNamespace(trace=made_up_trace([]))) is None


class RootedToy(toy.ToyProgram):
    """The toy program with a request's root and a witness fill of the
    port's spans around each call, as `api.encrypt` opens them."""

    def call(self, mix, call, zk=None):
        import torch

        from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans

        with spans.span("api.encrypt", messages=len(call.messages)):
            with spans.span("witness.fill", rows=len(call.messages)):
                torch.ones(64, dtype=torch.int32).cumsum(0)
            return super().call(mix, call, zk)


def test_a_traced_toy_run_reads_every_new_metric(tmp_path):
    cell = toy.toy_cell(trace=True)
    # one byte: the profiler records every op of the plain kernels
    cell = dataclasses.replace(cell, config=dataclasses.replace(
        cell.config, msg_len=1))
    program = RootedToy(cell.config)
    result, _lines = run.run_cell(
        cell, 2**33 + 11, 0.01, True, program,
        toy.ToyReference(cell.config), 0.0, device="cpu", scratch=tmp_path)
    assert result["correct"] is True
    tr, j = program_spans._state["joined"]
    assert j.proofs == 1 and j.spans
    assert all(sp.exact for sp in j.spans)
    records = j.records
    for sp, r in zip(j.spans, records):
        # the annotation lies within the host's record of the span
        assert r.t0 / 1e9 - 0.05 < sp.start <= sp.end < r.t1 / 1e9 + 0.05
    names = {r.name for r in records}
    assert {"api.encrypt", "witness.fill", "prove", "msm", "ntt",
            "host.hiding", "host.mask_draw", "wait.card"} <= names
    metrics = result["metrics"]
    assert set(READERS) <= set(metrics)
    host = {n: sum(sp.end - sp.start for sp, r in zip(j.spans, records)
                   if r.name == n) for n in names}
    assert metrics["hiding_ms_per_proof"]["value"] == pytest.approx(
        1e3 * host["host.hiding"])
    assert metrics["mask_draw_ms_per_proof"]["value"] == pytest.approx(
        1e3 * host["host.mask_draw"])
    assert metrics["card_wait_ms_per_proof"]["value"] == pytest.approx(
        1e3 * host["wait.card"])
    assert metrics["witness_ms_per_proof"]["value"] == pytest.approx(
        1e3 * host["witness.fill"])
    waits = sum(r.name == "wait.card" for r in records)
    assert metrics["card_waits_per_proof"]["value"] == waits
    (root,) = [r for r in records if r.parent is None]
    waits_cpu = sum(r.c1 - r.c0 for r in records if r.name == "wait.card")
    assert metrics["host_cpu_ms_per_proof"]["value"] == pytest.approx(
        (root.c1 - root.c0 - waits_cpu) / 1e6)
    assert metrics["host_cpu_ms_per_proof"]["unit"] == "ms/proof"
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
    assert not spans.enabled()
