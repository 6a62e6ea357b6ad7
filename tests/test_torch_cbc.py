"""The port's CBC mode against the JAX package: the oracle, the witness of
the 16- and 32-byte CBC templates (filled by the port's WitnessEvaluator on
the CPU) and the public instance a proof is checked against, all with zero
tolerance (every value is a bit or a byte); templates and indexed keys
cached apart by mode; and the truncated SRS a smaller key takes from a
larger checkpoint equal to the SRS generated at its own degree."""

import random

import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu import api as jax_api
from aes_zero_knowledge_proof_circuit_tpu.models.aes_circuit import (
    build_template as jax_build_template,
)
from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import srs as tsrs
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.serialize import save_srs
from tests.torch_threads import one_torch_thread  # noqa: F401

GEN = np.random.default_rng(20)


def random_bytes(n: int) -> bytes:
    return GEN.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's templates, cached in a directory of this module's own."""
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    yield api.CONFIG.cache_dir
    api.CONFIG.cache_dir = old


@pytest.mark.parametrize("length", [16, 32, 48])
def test_cbc_ciphertext_matches_reference(length):
    for _ in range(3):
        msg, key, iv = random_bytes(length), random_bytes(16), random_bytes(16)
        got = api.compute_ciphertext(msg, key, iv=iv)
        assert got == jax_api.compute_ciphertext(msg, key, iv=iv)
        assert len(got) == length and got != api.compute_ciphertext(msg, key)


@pytest.mark.parametrize("length", [16, 32])
def test_cbc_witness_matches_reference(cache, length, monkeypatch):
    """z from the port's template and evaluator equals the JAX template's
    host witness; its ciphertext bits are the oracle's, and z[:num_instance]
    is the instance verify_encryption builds: [1] + iv bits + ct bits. A
    proof of encrypt() is handed the same instance."""
    tpl = api._template_cached(length, "cbc")
    ref = jax_build_template(length, mode="cbc")
    assert tpl.mode == "cbc" and tpl.msg_len == length
    assert tpl.r1cs.num_instance == ref.r1cs.num_instance
    assert tpl.r1cs.num_instance == 1 + 128 + 8 * length
    ev = WitnessEvaluator(tpl.plan, "cpu")
    msg, key, iv = random_bytes(length), random_bytes(16), random_bytes(16)
    z = ev.evaluate_batch(api._witness_bits(tpl, [msg], key, iv))[0]
    np.testing.assert_array_equal(z.numpy(), ref.witness_z(msg, key, iv=iv))
    n_inst = tpl.r1cs.num_instance
    ct = api.compute_ciphertext(msg, key, iv=iv)
    assert z[1 + 128:n_inst].tolist() == api.bits_lsb_first(ct)

    seen = []
    monkeypatch.setattr(api._verifier, "verify",
                        lambda vk, inst, proof: seen.append(inst) or True)
    assert api.verify_encryption(None, None, ct, iv=iv)
    assert seen == [z[:n_inst].tolist()]

    class Recorder:
        def prove(self, instance, witness, rng=None, zk=True):
            return instance, witness

    pk = api.AESProvingKey(marlin_pk=None, template=tpl,
                           device=torch.device("cpu"), _prover=Recorder())
    instance, witness = api.encrypt(msg, key, pk, iv=iv)
    assert instance == seen[0]
    assert torch.equal(witness, z[n_inst:])


def test_templates_and_keys_are_cached_by_mode(cache):
    ecb = api._template_cached(16, "ecb")
    cbc = api._template_cached(16, "cbc")
    assert (ecb.mode, cbc.mode) == ("ecb", "cbc")
    assert (ecb.r1cs.num_instance, cbc.r1cs.num_instance) == (129, 257)
    again = api._template_cached(16, "cbc")      # from the disk cache
    assert again.mode == "cbc" and again.r1cs.num_instance == 257
    srs = tsrs.generate_srs_native(15, random.Random(3))
    paths = {api._pk_path(16, m, srs) for m in ("ecb", "cbc")}
    assert len(paths) == 2
    assert {p.name.split("_")[2] for p in paths} == {"ecb", "cbc"}


def test_truncated_srs_equals_one_of_its_own_degree(tmp_path, monkeypatch):
    """A key whose degree is below a checkpoint's takes the checkpoint's
    prefix; its bytes equal those of an SRS generated at its own degree
    from the same seed (tau and gamma are drawn before the powers)."""
    monkeypatch.setattr(api.CONFIG, "cache_dir", str(tmp_path))
    save_srs(str(api.CONFIG.srs_dir / "srs_bls377_v2_d63.npz"),
             tsrs.generate_srs_native(63, random.Random(3)))
    got = api._srs_for(31, None)
    want = tsrs.generate_srs_native(31, random.Random(3))
    assert got.max_degree == want.max_degree == 31
    assert tsrs.pack_points(got.powers_g1).tobytes() == \
        tsrs.pack_points(want.powers_g1).tobytes()
    assert list(got.gamma_powers_g1) == list(want.gamma_powers_g1)
    assert (got.h, got.tau_h) == (want.h, want.tau_h)
