"""A mesh proof (TorchProver(mesh=4 CPU shards): the 4n-domain transforms
four-step sharded, every MSM point-sharded) of the u32 add circuit of
tests/test_torch_prover_u32.py with zk=False equals the JAX package's host
prover's proof byte for byte (about 60 s: 76 shard MSMs through the plain
K3). The zk proof is in tests/test_torch_parallel_zk.py."""

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer, prover
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
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import make_mesh
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as ser
from tests.torch_threads import jax_srs, one_torch_thread  # noqa: F401


def u32_add_key():
    """(the JAX host key, instance, witness) of the u32 add circuit at
    0x89ABCDEF + 0x76543211, as tests/test_torch_prover_u32.py makes them."""
    cs, plan = build_u32_add()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    pk = indexer.index(cs, jax_srs(need, 5))

    def bits(v):
        return np.asarray([(v >> i) & 1 for i in range(32)], np.int32)

    z = WitnessEvaluator(convert.plan_from(plan), "cpu").evaluate(
        {"a": bits(0x89ABCDEF), "b": bits(0x76543211)})
    return pk, [int(v) for v in z[: cs.num_instance]], z[cs.num_instance:]


def test_mesh_nonzk_proof_equals_host_prover():
    pk, inst, wit = u32_add_key()
    want = prover.prove(pk, inst, [int(v) for v in wit], zk=False)
    tpk = convert.proving_key_from(pk)
    mesh = make_mesh(4, "cpu")
    tp = TorchProver(tpk, msm_engine="mxu", mesh=mesh)
    assert tp.device == mesh.first and len(tp.srs_shards) == 4
    got = tp.prove(inst, wit, zk=False)
    assert ser.serialize_proof(got) == jax_ser.serialize_proof(want)
    assert tverifier.verify(tpk.vk, inst, got)
    with pytest.raises(ValueError, match="mesh"):
        TorchProver(tpk, mesh=object())
