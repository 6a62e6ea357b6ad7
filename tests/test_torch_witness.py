"""Port witness fill vs the JAX WitnessEvaluator and the host plan."""

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.models.ops_demo import (
    build_u32_add,
    build_u32_xor,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.witness_jax import WitnessEvaluator
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator as TorchWitness,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

BUILDERS = {"add": build_u32_add, "xor": build_u32_xor}


def bits(v: int) -> np.ndarray:
    return np.asarray([(v >> i) & 1 for i in range(32)], np.int32)


@pytest.mark.parametrize("which", ["add", "xor"])
def test_witness_matches_jax_and_plan(which):
    r1cs, plan = BUILDERS[which]()
    port = TorchWitness(convert.plan_from(plan), "cpu")
    ref = WitnessEvaluator(plan)
    pairs = np.random.default_rng(5).integers(0, 1 << 32, size=(4, 2),
                                              dtype=np.uint64)
    for a, b in [(0, 0), ((1 << 32) - 1, 1)] + [tuple(map(int, p))
                                                 for p in pairs]:
        inputs = {"a": bits(a), "b": bits(b)}
        z = port.evaluate(inputs).numpy()
        np.testing.assert_array_equal(z, np.asarray(ref.evaluate(inputs)))
        np.testing.assert_array_equal(z, plan.evaluate(inputs))
        assert r1cs.is_satisfied([int(v) for v in z])
        out = sum(int(v) << i for i, v in enumerate(z[1:r1cs.num_instance]))
        assert out == ((a + b) & 0xFFFFFFFF if which == "add" else a ^ b)
