"""The port's prover as a whole, on the toy circuit of
tests/test_marlin.py (CPU: plain kernel versions). The JAX package builds
the circuit and the key; `convert.proving_key_from` carries the key across.

* zk=False proofs equal the host prover's byte for byte;
* zk=True proofs verify (the port's verifier) and a tampered instance is
  rejected;
* a seeded zk=True proof is the same with its hiding terms on the native
  library and on the Python fallback, eight terms a proof;
* (slow) zk=False and seeded zk=True proofs equal JaxProver's."""

import random

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover, verifier
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu.utils import serialize as jax_ser
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (
    verifier as tverifier,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import native
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as ser
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def toy():
    from tests.test_marlin import build_toy_circuit

    cs, assignment = build_toy_circuit()
    na, nb, nc = cs.nnz()
    srs = indexer.generate_universal_srs(
        cs.num_constraints, cs.num_variables, max(na, nb, nc),
        random.Random(21))
    return cs, assignment, indexer.index(cs, srs)


@pytest.fixture(scope="module")
def toy_prover(toy):
    return TorchProver(convert.proving_key_from(toy[2]), "cpu")


def assert_same_proof(got, want):
    """A port proof and a JAX-package proof, as serialized bytes."""
    assert ser.serialize_proof(got) == jax_ser.serialize_proof(want)


def test_nonzk_proof_equals_host(toy, toy_prover):
    _cs, assignment, pk = toy
    inst, wit = assignment(3, 4)
    want = prover.prove(pk, inst, wit, rng=random.Random(1), zk=False)
    got = toy_prover.prove(inst, np.asarray(wit), rng=random.Random(2),
                           zk=False)
    assert_same_proof(got, want)
    assert tverifier.verify(toy_prover.pk.vk, inst, got)
    assert verifier.verify(pk.vk, inst, want)


def test_zk_proof_verifies_and_rejects_tampered_instance(toy, toy_prover):
    _cs, assignment, _pk = toy
    inst, wit = assignment(6, 2)
    spans.enable()
    try:
        proof = toy_prover.prove(inst, np.asarray(wit), rng=random.Random(3),
                                 zk=True)
    finally:
        spans.disable()
    got, _counters = spans.drain()
    vk = toy_prover.pk.vk
    assert tverifier.verify(vk, inst, proof)
    bad = list(inst)
    bad[1] = (bad[1] + 1) % R_MOD
    assert not tverifier.verify(vk, bad, proof)
    assert [sp.name for sp in sorted(got, key=lambda sp: sp.t0)
            if sp.name.startswith("round.")] == [
        "round." + r for r in ("r1_polys", "r1_commits", "r2_polys",
                               "r2_commits", "r3_polys_commits", "evals",
                               "open_beta1", "open_beta2")]


def counted_prove(prover, inst, wit, zk):
    """A seeded prove with the spans' counters on: (serialized proof, the
    hiding counters)."""
    spans.enable()
    try:
        proof = prover.prove(inst, np.asarray(wit), rng=random.Random(17),
                             zk=zk)
    finally:
        spans.disable()
    _got, counters = spans.drain()
    return ser.serialize_proof(proof), {
        k: counters.get(k, 0) for k in ("hiding_terms", "hiding_terms_python")}


def test_hiding_terms_native_equal_python_fallback(toy, toy_prover,
                                                   monkeypatch):
    _cs, assignment, _pk = toy
    inst, wit = assignment(7, 5)
    assert native.available()
    got, counted = counted_prove(toy_prover, inst, wit, zk=True)
    assert counted == {"hiding_terms": 8, "hiding_terms_python": 0}
    assert counted_prove(toy_prover, inst, wit, zk=False)[1] == {
        "hiding_terms": 0, "hiding_terms_python": 0}
    monkeypatch.setattr(native, "lib", lambda: None)
    want, counted = counted_prove(toy_prover, inst, wit, zk=True)
    assert counted == {"hiding_terms": 0, "hiding_terms_python": 8}
    assert got == want


@pytest.mark.slow
def test_nonzk_proof_equals_jax_prover(toy, toy_prover):
    from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import JaxProver

    _cs, assignment, pk = toy
    inst, wit = assignment(5, 9)
    want = JaxProver(pk).prove(inst, np.asarray(wit, np.int32), zk=False)
    got = toy_prover.prove(inst, np.asarray(wit), zk=False)
    assert_same_proof(got, want)


@pytest.mark.slow
def test_seeded_zk_proof_equals_jax_prover(toy, toy_prover):
    from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import JaxProver

    _cs, assignment, pk = toy
    inst, wit = assignment(2, 11)
    want = JaxProver(pk).prove(inst, np.asarray(wit, np.int32),
                               rng=random.Random(99), zk=True)
    got = toy_prover.prove(inst, np.asarray(wit), rng=random.Random(99),
                           zk=True)
    assert_same_proof(got, want)
    assert tverifier.verify(toy_prover.pk.vk, inst, got)
