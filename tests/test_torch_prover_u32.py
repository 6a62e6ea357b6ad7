"""The port's prover on the u32 add circuit (models/ops_demo, n = 2^9, SRS
degree 1026): a zk=False proof equals the host prover's byte for byte, on
either MSM engine. The JAX package builds the circuit, plan, SRS and key;
`convert` carries them across."""


import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover, verifier
from aes_zero_knowledge_proof_circuit_tpu.models.ops_demo import build_u32_add
from aes_zero_knowledge_proof_circuit_tpu.utils import serialize as jax_ser
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (
    verifier as tverifier,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as ser
from tests.torch_threads import jax_srs, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def u32_add():
    cs, plan = build_u32_add()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    srs = jax_srs(need, 5)
    return cs, plan, srs


def _instance(cs, plan):
    bits = lambda v: np.asarray([(v >> i) & 1 for i in range(32)], np.int32)
    z = WitnessEvaluator(convert.plan_from(plan), "cpu").evaluate(
        {"a": bits(0x89ABCDEF), "b": bits(0x76543211)})
    return [int(v) for v in z[: cs.num_instance]], z[cs.num_instance:]


def test_nonzk_proof_equals_host(u32_add):
    cs, plan, srs = u32_add
    pk = indexer.index(cs, srs)
    inst, wit = _instance(cs, plan)
    want = prover.prove(pk, inst, [int(v) for v in wit], zk=False)
    tp = TorchProver(convert.proving_key_from(pk), "cpu")
    got = tp.prove(inst, wit, zk=False)
    assert ser.serialize_proof(got) == jax_ser.serialize_proof(want)
    assert tverifier.verify(tp.pk.vk, inst, got)
    assert verifier.verify(pk.vk, inst, want)


def test_nonzk_proof_on_the_pallas_engine_equals_host(u32_add, monkeypatch):
    """msm_engine="pallas" commits on the 8-bit bucket scan; ZKAES_MSM_MXU=0
    picks it as prover_jax does."""
    cs, plan, srs = u32_add
    pk = indexer.index(cs, srs)
    inst, wit = _instance(cs, plan)
    monkeypatch.setenv("ZKAES_MSM_MXU", "0")
    tpk = convert.proving_key_from(pk)
    tp = TorchProver(tpk, "cpu")
    assert tp.msm_engine == "pallas"
    want = prover.prove(pk, inst, [int(v) for v in wit], zk=False)
    got = tp.prove(inst, wit, zk=False)
    assert ser.serialize_proof(got) == jax_ser.serialize_proof(want)
    assert tverifier.verify(tpk.vk, inst, got)
    with pytest.raises(ValueError, match="msm_engine"):
        TorchProver(tpk, "cpu", msm_engine="fused")
