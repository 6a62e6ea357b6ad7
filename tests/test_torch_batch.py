"""The port's batched witness fill and `encrypt_batch` against the JAX
package, with zero tolerance (every value is a bit).

`evaluate_batch` equals per-message `evaluate`, the JAX package's
`jax.vmap(WitnessEvaluator._evaluate)` and the host plan. `encrypt_batch`
is recorded at the prover boundary in both packages: each package's prover
is replaced by a recorder, so no 16-byte proof runs on the CPU, and the
reference runs its own batched fill (its vmapped JAX evaluator, a second or
so on the CPU). Both must hand their provers the same instances and
witnesses, and `Random` states built from the same per-proof seeds."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu import api as jax_api
from aes_zero_knowledge_proof_circuit_tpu.models.ops_demo import (
    build_u32_add,
    build_u32_xor,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.witness_jax import evaluator_for
from aes_zero_knowledge_proof_circuit_tpu_torch import api, convert
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

BUILDERS = {"add": build_u32_add, "xor": build_u32_xor}
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def random_bits(gen, rows: int, width: int) -> np.ndarray:
    return gen.integers(0, 2, size=(rows, width), dtype=np.int32)


@pytest.mark.parametrize("which", ["add", "xor"])
def test_evaluate_batch_matches_jax_vmap(which):
    _r1cs, plan = BUILDERS[which]()
    port = WitnessEvaluator(convert.plan_from(plan), "cpu")
    gen = np.random.default_rng(7)
    a, b = random_bits(gen, 5, 32), random_bits(gen, 5, 32)
    a[0], b[0] = 1, 1                           # every carry set
    zs = port.evaluate_batch({"a": a, "b": b})
    assert zs.dtype == torch.int32 and zs.shape == (5, plan.num_vars)
    ev = evaluator_for(plan)
    want = np.asarray(jax.vmap(lambda x, y: ev._evaluate({"a": x, "b": y}))(
        jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(zs.numpy(), want)
    for i in range(5):
        one = port.evaluate({"a": a[i], "b": b[i]})
        assert torch.equal(zs[i], one)
        np.testing.assert_array_equal(one.numpy(),
                                      plan.evaluate({"a": a[i], "b": b[i]}))


def test_evaluate_batch_rejects_ragged_inputs():
    _r1cs, plan = build_u32_add()
    port = WitnessEvaluator(convert.plan_from(plan), "cpu")
    with pytest.raises(ValueError, match="batch size"):
        port.evaluate_batch({"a": np.zeros((2, 32), np.int32),
                             "b": np.zeros((3, 32), np.int32)})


@pytest.fixture(scope="module")
def ecb16(tmp_path_factory):
    """The 16-byte ECB template of each package (the port's built and
    cached in a directory of this module's own)."""
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    try:
        port = api._template_cached(16, "ecb")
    finally:
        api.CONFIG.cache_dir = old
    from aes_zero_knowledge_proof_circuit_tpu.models.aes_circuit import (
        build_template,
    )

    return port, build_template(16, mode="ecb")


def test_evaluate_batch_matches_plan_on_aes(ecb16):
    tpl, _ref = ecb16
    gen = np.random.default_rng(8)
    inputs = {"message": random_bits(gen, 3, 128),
              "key": random_bits(gen, 3, 128)}
    zs = WitnessEvaluator(tpl.plan, "cpu").evaluate_batch(inputs)
    for i in range(3):
        np.testing.assert_array_equal(
            zs[i].numpy(), tpl.plan.evaluate({k: v[i] for k, v in
                                              inputs.items()}))


class Recorder:
    """Stands in for a prover: returns what it was handed."""

    def prove(self, instance, witness, rng=None, zk=True):
        return (list(instance), np.asarray(witness).tolist(), rng.getstate(),
                zk)


def test_encrypt_batch_hands_the_prover_what_the_reference_does(ecb16):
    tpl, ref = ecb16
    gen = np.random.default_rng(9)
    messages = [gen.integers(0, 256, 16, dtype=np.uint8).tobytes()
                for _ in range(3)]
    port_pk = api.AESProvingKey(marlin_pk=None, template=tpl,
                                device=torch.device("cpu"),
                                _prover=Recorder())
    ref_pk = jax_api.AESProvingKey(marlin_pk=None, template=ref,
                                   backend="jax", _jax_prover=Recorder())
    got = api.encrypt_batch(messages, KEY, port_pk, rng=random.Random(11),
                            zk=False)
    want = jax_api.encrypt_batch(messages, KEY, ref_pk,
                                 rng=random.Random(11), zk=False)
    assert got == want
    # the seeds are drawn first, one a proof, from the caller's rng; proof i
    # is the one encrypt() makes from Random(seed i)
    draw = random.Random(11)
    seeds = [draw.randrange(1 << 62) for _ in messages]
    for i, (m, seed) in enumerate(zip(messages, seeds)):
        assert got[i][2] == random.Random(seed).getstate()
        assert api.encrypt(m, KEY, port_pk, rng=random.Random(seed),
                           zk=False) == got[i]
        ct = api.compute_ciphertext(m, KEY)
        assert got[i][0] == [1] + api.bits_lsb_first(ct)
