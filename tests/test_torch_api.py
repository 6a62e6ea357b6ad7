"""The port's API surface: what it accepts, and the typed errors for what
it does not do yet (CBC, batches, meshes)."""

import pytest

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
    with pytest.raises(TypeError):
        api.synthesize_keys(16)


@pytest.mark.parametrize("call", [
    lambda: api.synthesize_keys(16, mode="cbc", device="cpu"),
    lambda: api.encrypt_batch([MSG], KEY, None),
    lambda: api.encrypt(MSG, KEY, None, iv=bytes(16)),
    lambda: api.encrypt(MSG, KEY, None, mesh=object()),
    lambda: api.compute_ciphertext(MSG, KEY, iv=bytes(16)),
    lambda: api.verify_encryption(None, None, MSG, iv=bytes(16)),
], ids=["cbc-keys", "batch", "cbc-encrypt", "mesh", "cbc-ct", "cbc-verify"])
def test_not_ported_paths_raise_typed_error(call):
    with pytest.raises(api.NotPortedError):
        call()
    assert issubclass(api.NotPortedError, api.ZkAesError)


@pytest.mark.parametrize("length", [0, 15, 17])
def test_bad_lengths_raise_invalid_input(length):
    with pytest.raises(api.InvalidInputError):
        api.synthesize_keys(length, device="cpu")
    with pytest.raises(api.InvalidInputError):
        api.verify_encryption(None, None, bytes(length))
