"""The port's prover as a whole, on the toy circuit of
tests/test_marlin.py (CPU: plain kernel versions).

* zk=False proofs equal the host prover's field for field;
* zk=True proofs verify and a tampered instance is rejected;
* (slow) zk=False and seeded zk=True proofs equal JaxProver's."""

import random

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover, verifier
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
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
    return TorchProver(toy[2], "cpu")


def assert_same_proof(a, b):
    for name in a.__dataclass_fields__:
        assert getattr(a, name) == getattr(b, name), name


def test_nonzk_proof_equals_host(toy, toy_prover):
    _cs, assignment, pk = toy
    inst, wit = assignment(3, 4)
    want = prover.prove(pk, inst, wit, rng=random.Random(1), zk=False)
    got = toy_prover.prove(inst, np.asarray(wit), rng=random.Random(2),
                           zk=False)
    assert_same_proof(got, want)
    assert verifier.verify(pk.vk, inst, got)


def test_zk_proof_verifies_and_rejects_tampered_instance(toy, toy_prover):
    _cs, assignment, pk = toy
    inst, wit = assignment(6, 2)
    proof = toy_prover.prove(inst, np.asarray(wit), rng=random.Random(3),
                             zk=True)
    assert verifier.verify(pk.vk, inst, proof)
    bad = list(inst)
    bad[1] = (bad[1] + 1) % R_MOD
    assert not verifier.verify(pk.vk, bad, proof)
    assert list(toy_prover.last_stage_times) == [
        "r1_polys", "r1_commits", "r2_polys", "r2_commits",
        "r3_polys_commits", "evals", "open_beta1", "open_beta2"]


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
    assert verifier.verify(pk.vk, inst, got)
