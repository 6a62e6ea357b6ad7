"""The port's prover on the u32 add circuit (models/ops_demo, n = 2^9, SRS
degree 1026): a zk=False proof equals the host prover's field for field."""

import random

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover, verifier
from aes_zero_knowledge_proof_circuit_tpu.models.ops_demo import build_u32_add
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def u32_add():
    cs, plan = build_u32_add()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    srs = generate_srs_native(need, random.Random(5))
    return cs, plan, srs


def test_nonzk_proof_equals_host(u32_add):
    cs, plan, srs = u32_add
    pk = indexer.index(cs, srs)
    bits = lambda v: np.asarray([(v >> i) & 1 for i in range(32)], np.int32)
    z = WitnessEvaluator(plan, "cpu").evaluate(
        {"a": bits(0x89ABCDEF), "b": bits(0x76543211)})
    inst = [int(v) for v in z[: cs.num_instance]]
    wit = z[cs.num_instance:]
    want = prover.prove(pk, inst, [int(v) for v in wit], zk=False)
    got = TorchProver(pk, "cpu").prove(inst, wit, zk=False)
    for name in want.__dataclass_fields__:
        assert getattr(got, name) == getattr(want, name), name
    assert verifier.verify(pk.vk, inst, got)
