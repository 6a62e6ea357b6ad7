"""A seeded zk proof of the u32 add circuit on a mesh of 4 CPU shards is
byte-equal to the port's single-device proof from the same seed, verifies
with the port's verifier and rejects a wrong instance (about 110 s: both
proofs run the plain kernels)."""

import random

from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (
    verifier as tverifier,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import make_mesh
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as ser
from tests.test_torch_parallel_prover import u32_add_key
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_mesh_zk_proof_equals_single_device_and_verifies():
    pk, inst, wit = u32_add_key()
    tpk = convert.proving_key_from(pk)
    single = TorchProver(tpk, "cpu").prove(inst, wit, rng=random.Random(3))
    got = TorchProver(tpk, mesh=make_mesh(4, "cpu")).prove(
        inst, wit, rng=random.Random(3))
    assert ser.serialize_proof(got) == ser.serialize_proof(single)
    assert tverifier.verify(tpk.vk, inst, got)
    bad = list(inst)
    bad[1] = (bad[1] + 1) % R_MOD
    assert not tverifier.verify(tpk.vk, bad, got)
