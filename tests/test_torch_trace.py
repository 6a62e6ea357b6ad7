"""The port's spans and counters (`utils/spans.py`), on the CPU.

* Off (the default), `span()` returns the shared no-op and nothing is
  recorded or annotated; a prove synchronizes nothing at a stage's end.
* On, an `api.encrypt` of the 16-byte template, its prover standing in
  for a toy circuit's `TorchProver`, gives the tree the benchmark reads:
  the request's root, the witness fill, the prove tiled by its eight
  rounds and each round's MSMs, NTTs, host sections and card waits, one
  request id and one proof id; a two-deep `encrypt_batch` gives two
  proofs on two threads under the batch's root.
* Each `host.hiding` span opens after its batch's MSMs and ends before
  their points are read back (`wait.card(xyzz_to_affine)`).
* The buffer's bound, the count of dropped spans, and `drain()`.
* An `api.encrypt` on a Plonk key (the stand-in circuit of
  `tests/torch_threads.py`) gives the Plonk tree: the witness fill with
  its uploads, the prove tiled by its five rounds, the blinding draws,
  the grand product and the quotient (its six 4n transforms, counted in
  `coset_ntts`); with the facility off a seeded proof is byte-equal.
"""

import collections
import os
import random
import threading

import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
    TorchProver,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.models.r1cs import R1CS
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
    preprocess,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native,
)
from tests.torch_threads import CiphertextPairs
from tests.torch_threads import one_torch_thread  # noqa: F401

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
ROUNDS = ["r1_polys", "r1_commits", "r2_polys", "r2_commits",
          "r3_polys_commits", "evals", "open_beta1", "open_beta2"]
# the children each round of a zk prove has at least
CHILDREN = {
    "r1_polys": {"ntt", "host.transcript", "wait.card"},
    "r1_commits": {"host.mask_draw", "msm", "host.hiding",
                   "host.transcript", "wait.card"},
    "r2_polys": {"ntt", "wait.card"},
    "r2_commits": {"msm", "host.hiding", "host.transcript", "wait.card"},
    "r3_polys_commits": {"ntt", "msm", "host.transcript", "wait.card"},
    "evals": {"host.transcript", "wait.card"},
    "open_beta1": {"msm", "host.hiding", "wait.card"},
    "open_beta2": {"msm", "wait.card"},
}
TOY_BITS = 8


def xor_circuit():
    """c = m xor k over TOY_BITS bits: m and k boolean, (2m) k = m + k - c."""
    cs = R1CS()
    c = [cs.new_instance_var() for _ in range(TOY_BITS)]
    m = [cs.new_witness_var() for _ in range(TOY_BITS)]
    k = [cs.new_witness_var() for _ in range(TOY_BITS)]
    for ci, mi, ki in zip(c, m, k):
        cs.enforce({mi: 1}, {mi: 1}, {mi: 1})
        cs.enforce({ki: 1}, {ki: 1}, {ki: 1})
        cs.enforce({mi: 2}, {ki: 1}, {mi: 1, ki: 1, ci: R_MOD - 1})
    return cs.finalized()


M_BITS = [1, 0, 1, 1, 0, 0, 1, 0]
K_BITS = [0, 1, 1, 0, 1, 0, 0, 1]
TOY_INSTANCE = [1] + [a ^ b for a, b in zip(M_BITS, K_BITS)]


@pytest.fixture(scope="module")
def toy_prover():
    cs = xor_circuit()
    na, nb, nc = cs.nnz()
    srs = kzg.setup(indexer.required_degree(
        cs.num_constraints, cs.num_variables, max(na, nb, nc)),
        random.Random(5))
    return TorchProver(indexer.index(cs, srs, "cpu"), "cpu")


class ToyStandIn:
    """The key's prover for the API: proves the toy statement whatever
    the API hands it (a 16-byte AES proof is too large for the CPU); with
    a barrier, each prove waits there for another to be in flight."""

    def __init__(self, prover, barrier=None):
        self.prover = prover
        self.barrier = barrier

    def prove(self, instance, witness, rng=None, zk=True):
        if self.barrier is not None:
            self.barrier.wait()
        return self.prover.prove(TOY_INSTANCE, M_BITS + K_BITS, rng=rng,
                                 zk=zk)


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    try:
        return api._template_cached(16, "ecb")
    finally:
        api.CONFIG.cache_dir = old


def cpu_key(template, prover):
    return api.AESProvingKey(marlin_pk=None, template=template,
                             device=torch.device("cpu"), _prover=prover)


@pytest.fixture(autouse=True)
def facility_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def traced(fn):
    """fn() with the facility on: (its result, spans, counters)."""
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    got, counters = spans.drain()
    return out, got, counters


@pytest.fixture(scope="module")
def encrypted(template, toy_prover):
    key = cpu_key(template, ToyStandIn(toy_prover))
    spans.enable()
    try:
        api.encrypt(bytes(range(16)), KEY, key, rng=random.Random(7))
    finally:
        spans.disable()
    return spans.drain()


def children(got):
    out = collections.defaultdict(list)
    for sp in got:
        out[sp.parent].append(sp)
    for kids in out.values():
        kids.sort(key=lambda sp: sp.t0)
    return out


class Forbidden:
    """Records calls of what no span and no stage end may call."""

    def __init__(self):
        self.calls = []

    def __call__(self, what):
        def call(*args, **kwargs):
            self.calls.append(what)
            raise AssertionError(f"{what} called")
        return call


@pytest.fixture(scope="module")
def off_prove(toy_prover):
    """A prove with the facility off, with the profiler's annotation and
    every CUDA synchronization replaced by a recorder that raises."""
    forbidden = Forbidden()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function",
                   forbidden("record_function"))
        mp.setattr(torch.cuda, "synchronize", forbidden("synchronize"))
        mp.setattr(torch.cuda, "current_stream", forbidden("current_stream"))
        mp.setattr(torch.cuda.Stream, "synchronize",
                   forbidden("Stream.synchronize"))
        mp.setattr(torch.cuda.Event, "synchronize",
                   forbidden("Event.synchronize"))
        spans.disable()
        proof = toy_prover.prove(TOY_INSTANCE, M_BITS + K_BITS,
                                 rng=random.Random(3), zk=True)
        assert spans.span("x", a=1) is spans.OFF
        assert spans.rounds(torch.device("cuda", 0)) is spans.OFF
        assert spans.wait("w", upload=4) is spans.OFF
        assert spans.current() is None
        return proof, spans.drain(), forbidden.calls


def test_off_records_nothing_and_annotates_nothing(off_prove):
    proof, (got, counters), calls = off_prove
    assert proof.comm_s.point is not None
    assert got == [] and counters == {}
    assert "record_function" not in calls


def test_no_stage_end_synchronizes(off_prove, monkeypatch):
    """Off, the prove called no synchronization; on, a round's end on a
    card reads the allocator, and synchronizes nothing either."""
    assert off_prove[2] == []
    forbidden = Forbidden()
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden("synchronize"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        forbidden("current_stream"))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 5)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 7)

    def stages():
        with spans.span("prove"), \
                spans.rounds(torch.device("cuda", 0)) as round_:
            round_("r1_polys")
            round_("r1_commits")

    _, got, _ = traced(stages)
    assert forbidden.calls == []
    rounds = [sp for sp in got if sp.name.startswith("round.")]
    assert [sp.name for sp in rounds] == ["round.r1_polys",
                                          "round.r1_commits"]
    assert all(sp.attrs == {"allocated": 5, "peak": 7} for sp in rounds)


def test_a_request_is_one_tree(encrypted):
    got, counters = encrypted
    kids = children(got)
    (root,) = kids[None]
    assert root.name == "api.encrypt" and root.attrs == {"messages": 1}
    assert {sp.request for sp in got} == {root.id}
    names = [sp.name for sp in kids[root.id]]
    assert names.index("witness.fill") < names.index("prove")
    (fill,) = [sp for sp in kids[root.id] if sp.name == "witness.fill"]
    assert fill.attrs == {"rows": 1} and fill.proof is None
    (prove,) = [sp for sp in kids[root.id] if sp.name == "prove"]
    assert set(prove.attrs) == {"engine", "n"}
    assert prove.attrs["engine"] == "mxu"
    inside = [sp for sp in got if sp.proof == prove.id]
    assert {sp.proof for sp in got} == {None, prove.id}
    rounds = kids[prove.id]
    assert [sp.name for sp in rounds] == ["round." + r for r in ROUNDS]
    for sp in rounds:
        have = {c.name for c in kids[sp.id]}
        assert CHILDREN[sp.name[len("round."):]] <= have, sp.name
    # the rounds tile the prove: one begins where the last ends
    assert rounds[0].t0 >= prove.t0 and rounds[-1].t1 <= prove.t1
    for a, b in zip(rounds, rounds[1:]):
        assert 0 <= b.t0 - a.t1 < 50_000_000
    assert sum(sp.t1 - sp.t0 for sp in rounds) >= 0.9 * (prove.t1 - prove.t0)
    for sp in inside:
        if sp.name == "msm":
            assert set(sp.attrs) == {"points", "engine"}
        if sp.name == "ntt":
            assert set(sp.attrs) == {"n", "rows"}
    waits = [sp for sp in got if sp.name == "wait.card"]
    assert counters["card_waits"] == len(waits)
    assert counters["upload_bytes"] + counters["readback_bytes"] == sum(
        sp.attrs["bytes"] for sp in waits)
    # no card wait holds another, and no span of a kind holds its kind
    by_id = {sp.id: sp for sp in got}
    for sp in got:
        assert by_id.get(sp.parent, root).name != sp.name or sp is root


def test_hiding_terms_run_while_the_msms_are_queued(encrypted):
    got, counters = encrypted
    kids = children(got)
    hidings = [sp for sp in got if sp.name == "host.hiding"]
    assert len(hidings) == 3   # r1_commits, r2_commits, open_beta1
    for sp in hidings:
        siblings = kids[sp.parent]
        i = siblings.index(sp)
        assert siblings[i - 1].name == "msm"
        readback = [s for s in siblings[i + 1:] if s.name == "wait.card"
                    and s.attrs["what"] == "xyzz_to_affine"][0]
        assert siblings[i - 1].t1 <= sp.t0 and sp.t1 <= readback.t0
    assert counters["hiding_terms"] == 8
    assert counters["hiding_terms_python"] == 0


def test_cpu_time_within_wall_time(encrypted):
    got, _ = encrypted
    assert got
    for sp in got:
        assert 0 <= sp.c1 - sp.c0 <= sp.t1 - sp.t0, sp


def test_a_two_deep_batch_proves_on_two_threads(template, toy_prover,
                                                monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    key = cpu_key(template, ToyStandIn(toy_prover,
                                       threading.Barrier(2, timeout=120)))
    proofs, got, counters = traced(lambda: api.encrypt_batch(
        [bytes(16), bytes(range(16))], KEY, key, rng=random.Random(9)))
    assert len(proofs) == 2
    (root,) = [sp for sp in got if sp.parent is None]
    assert root.name == "api.encrypt_batch" and root.attrs == {"messages": 2}
    proves = [sp for sp in got if sp.name == "prove"]
    assert len(proves) == 2
    assert all(sp.parent == root.id and sp.request == root.id
               for sp in proves)
    assert len({sp.proof for sp in proves}) == 2
    assert len({sp.tid for sp in proves}) == 2
    assert root.tid not in {sp.tid for sp in proves}
    assert {sp.request for sp in got} == {root.id}
    for sp in proves:
        mine = [s for s in got if s.proof == sp.id]
        assert {s.tid for s in mine} == {sp.tid}
        assert sum(s.name.startswith("round.") for s in mine) == 8
    (fill,) = [sp for sp in got if sp.name == "witness.fill"]
    assert fill.parent == root.id and fill.attrs == {"rows": 2}
    assert counters["card_waits"] == sum(sp.name == "wait.card" for sp in got)


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "_spans", collections.deque(maxlen=3))

    def five():
        for i in range(5):
            with spans.span("s", i=i):
                pass

    _, got, counters = traced(five)
    assert [sp.attrs["i"] for sp in got] == [2, 3, 4]
    assert counters == {"dropped_spans": 2}


def test_drain_clears_spans_and_counters():
    def some():
        with spans.span("outer"):
            with spans.wait("copy", readback=8):
                pass

    spans.enable()
    some()
    got, counters = spans.drain()
    assert [sp.name for sp in got] == ["wait.card", "outer"]
    assert got[0].parent == got[1].id
    assert counters == {"card_waits": 1, "readback_bytes": 8}
    assert spans.drain() == ([], {})
    some()
    spans.disable()
    assert len(spans.drain()[0]) == 2
    assert spans.drain() == ([], {})


PLONK_ROUNDS = ["r1_wires", "r2_grand_product", "r3_quotient", "r4_evals",
                "r5_open"]


@pytest.fixture(scope="module")
def plonk_key():
    toy = CiphertextPairs()
    data = toy.circuit.compile()
    pk, prover = preprocess(data, generate_srs_native(
        data.n + 5, random.Random(4)), "cpu")
    return api.AESPlonkProvingKey(circuit=toy, plonk_pk=pk,
                                  device=torch.device("cpu"), _prover=prover)


@pytest.fixture(scope="module")
def plonk_traced(plonk_key):
    spans.enable()
    try:
        proof = api.encrypt(bytes(range(16)), KEY, plonk_key,
                            rng=random.Random(7))
    finally:
        spans.disable()
    return (proof,) + spans.drain()


def test_a_plonk_request_is_one_tree(plonk_traced):
    _proof, got, counters = plonk_traced
    kids = children(got)
    (root,) = kids[None]
    assert root.name == "api.encrypt"
    assert {sp.request for sp in got} == {root.id}
    assert [sp.name for sp in kids[root.id]] == ["witness.fill", "prove"]
    fill, prove = kids[root.id]
    assert fill.attrs == {"rows": 1} and fill.proof is None
    # the three columns' uploads are queued without waiting for the card
    assert not [sp for sp in kids[fill.id] if sp.name == "wait.card"]
    assert counters["upload_bytes"] >= 3 * 256 * 8
    rounds = kids[prove.id]
    assert [sp.name for sp in rounds] == ["round." + r for r in PLONK_ROUNDS]
    assert rounds[0].t0 >= prove.t0 and rounds[-1].t1 <= prove.t1
    for a, b in zip(rounds, rounds[1:]):
        assert 0 <= b.t0 - a.t1 < 50_000_000
    assert sum(sp.t1 - sp.t0 for sp in rounds) >= 0.9 * (prove.t1 - prove.t0)
    by_round = {sp.name[len("round."):]: {c.name: c for c in kids[sp.id]}
                for sp in rounds}
    draws = [sp for sp in got if sp.name == "host.mask_draw"]
    assert [sp.attrs["elements"] for sp in draws] == [6, 3, 2]
    assert [sp.parent for sp in draws] == [
        by_round[r]["host.mask_draw"].parent for r in PLONK_ROUNDS[:3]]
    assert "plonk.grand_product" in by_round["r2_grand_product"]
    quotient = by_round["r3_quotient"]["plonk.quotient"]
    transforms = [sp for sp in kids[quotient.id] if sp.name == "ntt"]
    assert [sp.attrs["n"] for sp in transforms] == [4 * 256] * 6
    assert counters["coset_ntts"] == 6
    waits = [sp for sp in got if sp.name == "wait.card"]
    assert counters["card_waits"] == len(waits) >= 1
    # the host waits for what the transcript reads, and for no upload of
    # the prover's own (from_ints here: the CPU's plain MSM puts its sum
    # back on the device)
    assert {"xyzz_to_affine", "to_ints"} <= {
        sp.attrs["what"] for sp in waits} <= {
        "xyzz_to_affine", "to_ints", "from_ints"}
    assert all(sp.proof == prove.id for sp in got
               if sp.name.startswith(("round.", "plonk.", "host.")))


def test_spans_leave_a_plonk_proof_as_it_was(plonk_key, plonk_traced):
    proof = plonk_traced[0]
    off = api.encrypt(bytes(range(16)), KEY, plonk_key, rng=random.Random(7))
    assert api.serialize_proof(off) == api.serialize_proof(proof)
    assert spans.drain() == ([], {})
