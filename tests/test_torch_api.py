"""The port's API surface: what it accepts, the typed errors for invalid
input (a mesh that is not a port Mesh among them), and the entry points'
device: the CUDA card unless the caller asks for the CPU, never a quiet
fallback."""

from types import SimpleNamespace

import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu import api as jax_api
from aes_zero_knowledge_proof_circuit_tpu_torch import api

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
MSG = bytes(range(16))


def test_compute_ciphertext_and_bits_match_reference():
    assert api.compute_ciphertext(MSG, KEY) == jax_api.compute_ciphertext(
        MSG, KEY)
    # FIPS-197 appendix B
    assert api.compute_ciphertext(
        bytes.fromhex("3243f6a8885a308d313198a2e0370734"), KEY).hex() == \
        "3925841d02dc09fbdc118597196a0b32"
    assert api.bits_lsb_first(b"\x01\x80") == jax_api.bits_lsb_first(
        b"\x01\x80")


def test_device_is_required():
    """The default device is CUDA; without a card the call raises before
    any setup work, and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.synthesize_keys(16)


@pytest.mark.parametrize("entry", ["prover", "index", "witness", "main",
                                   "plonk_prover"])
def test_entry_points_default_to_cuda(entry):
    from aes_zero_knowledge_proof_circuit_tpu_torch import __main__ as cli
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
        TorchProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
        WitnessEvaluator,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
        TorchPlonkProver,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    call = {"prover": lambda: TorchProver(None),
            "index": lambda: indexer.index(None, None),
            "witness": lambda: WitnessEvaluator(None),
            "main": lambda: cli.main([]),
            "plonk_prover": lambda: TorchPlonkProver(None)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("call", [
    lambda: api.encrypt(MSG, KEY, None, mesh=object()),
    lambda: api.encrypt_batch([MSG], KEY, None, mesh=object()),
], ids=["mesh", "batch-mesh"])
def test_not_ported_paths_raise_typed_error(call):
    """A mesh that is not a parallel.mesh.Mesh is invalid input, refused
    before the proving key is read."""
    with pytest.raises(api.InvalidInputError, match="mesh must be"):
        call()


def key_for(mode: str) -> api.AESProvingKey:
    """A proving key that holds only what the input checks read."""
    return api.AESProvingKey(marlin_pk=None, device=torch.device("cpu"),
                             template=SimpleNamespace(msg_len=16, mode=mode))


@pytest.mark.parametrize("call", [
    lambda: api.synthesize_keys(16, mode="ctr", device="cpu"),
    lambda: api.encrypt(MSG, KEY, key_for("ecb"), iv=bytes(16)),
    lambda: api.encrypt(MSG, KEY, key_for("cbc")),
    lambda: api.encrypt(MSG, KEY, key_for("cbc"), iv=bytes(15)),
    lambda: api.verify_encryption(None, None, MSG, iv=bytes(15)),
    lambda: api.encrypt_batch([], KEY, key_for("ecb")),
    lambda: api.encrypt_batch([MSG], KEY, key_for("cbc")),
    lambda: api.encrypt_batch([MSG, MSG[:15]], KEY, key_for("ecb")),
    lambda: api.encrypt_batch([MSG], KEY[:15], key_for("ecb")),
], ids=["bad-mode", "iv-with-ecb", "cbc-without-iv", "cbc-iv-15",
        "verify-iv-15", "empty-batch", "batch-on-cbc", "batch-msg-15",
        "batch-key-15"])
def test_invalid_inputs_raise_invalid_input(call):
    """Where the JAX package raises InvalidInputError, the port does too,
    before any setup or proving work."""
    with pytest.raises(api.InvalidInputError):
        call()


def test_reference_style_positional_backend_fails_at_the_call():
    """The JAX package's third positional parameter is its backend; here
    everything after rng is keyword-only, so such a call fails at once."""
    with pytest.raises(TypeError):
        api.synthesize_keys(16, None, "jax")


@pytest.mark.parametrize("length", [0, 15, 17])
def test_bad_lengths_raise_invalid_input(length):
    with pytest.raises(api.InvalidInputError):
        api.synthesize_keys(length, device="cpu")
    with pytest.raises(api.InvalidInputError):
        api.verify_encryption(None, None, bytes(length))
