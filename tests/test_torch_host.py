"""The port's copies of the host code against the JAX package's originals:
proofs cross between the two serializers and verifiers in both directions,
zk=False proof bytes and verifying keys are equal, and the SRS degree, the
transcript's challenges and AES-128 on the FIPS-197 vectors agree."""

import random

import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer as jindexer
from aes_zero_knowledge_proof_circuit_tpu.marlin import prover as jprover
from aes_zero_knowledge_proof_circuit_tpu.marlin import verifier as jverifier
from aes_zero_knowledge_proof_circuit_tpu.models.r1cs import R1CS
from aes_zero_knowledge_proof_circuit_tpu.ops import aes_host as jaes
from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    g1_generator as jg1,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu.utils import serialize as jser
from aes_zero_knowledge_proof_circuit_tpu.utils import transcript as jtr
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (
    indexer as tindexer,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (
    verifier as tverifier,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import aes_host as taes
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.curve_host import (
    g1_generator as tg1,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as tser
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import transcript as ttr
from tests.torch_threads import jax_srs, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def toy():
    """x*y = out1, (x+y)*z = out2, x*x = z, built and indexed by the JAX
    package; (JAX key, the port's key carried across, instance, witness)."""
    cs = R1CS()
    out1, out2 = cs.new_instance_var(), cs.new_instance_var()
    x, y, z = cs.new_witness_var(), cs.new_witness_var(), cs.new_witness_var()
    cs.enforce({x: 1}, {y: 1}, {out1: 1})
    cs.enforce({x: 1, y: 1}, {z: 1}, {out2: 1})
    cs.enforce({x: 1}, {x: 1}, {z: 1})
    cs = cs.finalized()
    xv, yv = 3, 4
    zv = xv * xv % R_MOD
    inst = [1, xv * yv % R_MOD, (xv + yv) * zv % R_MOD]
    na, nb, nc = cs.nnz()
    srs = jax_srs(jindexer.required_degree(
        cs.num_constraints, cs.num_variables, max(na, nb, nc)),
        5)
    pk = jindexer.index(cs, srs)
    return pk, convert.proving_key_from(pk), inst, [xv, yv, zv]


def _flipped(inst):
    bad = list(inst)
    bad[1] ^= 1
    return bad


def test_port_proof_verifies_with_the_jax_verifier(toy):
    pk, tpk, inst, wit = toy
    proof = TorchProver(tpk, "cpu").prove(inst, wit, rng=random.Random(1))
    back = jser.deserialize_proof(tser.serialize_proof(proof))
    assert jverifier.verify(pk.vk, inst, back)
    assert not jverifier.verify(pk.vk, _flipped(inst), back)
    assert tverifier.verify(tpk.vk, inst, proof)
    assert not tverifier.verify(tpk.vk, _flipped(inst), proof)


def test_jax_proof_verifies_with_the_port_verifier(toy):
    pk, tpk, inst, wit = toy
    proof = jprover.prove(pk, inst, wit, rng=random.Random(2))
    back = tser.deserialize_proof(jser.serialize_proof(proof))
    assert tverifier.verify(tpk.vk, inst, back)
    assert not tverifier.verify(tpk.vk, _flipped(inst), back)
    assert not jverifier.verify(pk.vk, _flipped(inst), proof)


def test_nonzk_proof_bytes_equal_the_host_prover(toy):
    pk, tpk, inst, wit = toy
    got = TorchProver(tpk, "cpu").prove(inst, wit, zk=False)
    want = jprover.prove(pk, inst, wit, zk=False)
    assert tser.serialize_proof(got) == jser.serialize_proof(want)


def test_port_index_equals_the_jax_index(toy):
    """The port's own indexer on the carried circuit and SRS gives the
    JAX package's verifying key, byte for byte."""
    pk, _tpk, _inst, _wit = toy
    tpk = tindexer.index(convert.r1cs_from(pk.r1cs), convert.srs_from(pk.srs),
                         "cpu")
    assert tser.serialize_vk(tpk.vk) == jser.serialize_vk(pk.vk)


@pytest.mark.parametrize("shape", [(3, 6, 4), (1000, 1100, 5000),
                                   (866_944, 513, 4_062_064), (1, 1, 1)])
def test_required_degree_agrees(shape):
    assert tindexer.required_degree(*shape) == jindexer.required_degree(*shape)


def test_transcript_challenges_agree():
    ts = (jtr.Transcript(), ttr.Transcript())
    gens = (jg1(), tg1())
    for t, g in zip(ts, gens):
        t.absorb_bytes(b"label", b"\x01\x02\x03")
        t.absorb_u64(b"n", 1 << 40)
        t.absorb_fr(b"x", R_MOD - 1)
        t.absorb_fr_list(b"xs", [0, 1, 2, R_MOD - 2])
        t.absorb_g1(b"g", g)
    a, b = ts
    assert a.challenge_fr(b"alpha") == b.challenge_fr(b"alpha")
    assert a.challenge_fr_list(b"etas", 3) == b.challenge_fr_list(b"etas", 3)


@pytest.mark.parametrize("key,plain,cipher", [
    # FIPS-197 Appendix B and Appendix C.1
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
])
def test_aes_fips197_vectors_agree(key, plain, cipher):
    k, p = bytes.fromhex(key), bytes.fromhex(plain)
    got = bytes(taes.encrypt_ecb(p, k).astype("uint8"))
    assert got == bytes.fromhex(cipher)
    assert got == bytes(jaes.encrypt_ecb(p, k).astype("uint8"))
