"""AES-Plonk through the port's API, on the CPU, with a stand-in circuit
(`CiphertextPairs`: the AES circuit's interface and public values at
n = 256) in place of the 272,544-gate AES circuit, which is too large to
prove here. The stand-in goes through the same key, cache, prove and
codec code as the real circuit:

* `synthesize_keys(16, rng, proof_system="plonk", device="cpu")` draws
  its SRS of degree n + 5 from `rng` through `_srs_for`, preprocesses on
  the device and caches the key; a second call loads it, and proves
  byte-equal to the first;
* the device preprocessing gives the host `setup`'s verifying key;
* a zk=False proof equals the host prover's with every blinding scalar 0
  and draws nothing; a seeded zk=True proof equals the host prover's and
  the direct `TorchPlonkProver.prove`'s from the same seed;
* `serialize_proof` writes "ZKAESPLK" v1, 636 bytes, equal to the
  benchmark reference's own codec (`zkbench/ref/plonk/proof.py`), and
  `deserialize_proof` reads it back and refuses what is not canonical;
* a proof verifies under the port's verifier and the reference's, and
  neither accepts it for a flipped public bit;
* `encrypt_batch` proves in turn, each message from its seed;
* Plonk is refused at 32 bytes, in CBC mode, under an unknown proof
  system, with an iv and on a mesh."""

import random

import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import make_mesh
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import backend
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.config import Config
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.errors import (
    InvalidInputError,
    SerializationError,
)
from tests.torch_threads import CiphertextPairs, NoDraws, ZeroDraws
from tests.torch_threads import one_torch_thread  # noqa: F401
from zkbench.ref.plonk import proof as ref_proof
from zkbench.ref.plonk.circuit import PlonkCircuit as RefPlonkCircuit
from zkbench.ref.plonk.key import derive_key
from zkbench.ref.plonk.verify import verify as ref_verify

SRS_SEED = 2026
MSG = bytes(range(16))
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CT = bytes(api.compute_ciphertext(MSG, KEY))


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """Two `synthesize_keys` of the stand-in under one seed: the first
    generates the SRS and preprocesses, the second loads both. The
    template and SRS directories point at a temporary one (the native
    library stays where it was built)."""
    cache = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, "template_dir", property(lambda self: cache))
        mp.setattr(Config, "srs_dir", property(lambda self: cache))
        mp.setattr(api, "AesPlonkCircuit", CiphertextPairs)
        fresh = api.synthesize_keys(16, random.Random(SRS_SEED),
                                    proof_system="plonk", device="cpu")
        files = sorted(p.name for p in cache.iterdir())
        loaded = api.synthesize_keys(16, random.Random(SRS_SEED),
                                     proof_system="plonk", device="cpu")
    return fresh, loaded, files


@pytest.fixture(scope="module")
def host_pk(keys):
    (key, _vk), _loaded, _files = keys
    return backend.setup(key.circuit.circuit, srs=key.plonk_pk.srs)


@pytest.fixture(scope="module")
def seeded(keys):
    (key, _vk), _loaded, _files = keys
    return api.encrypt(MSG, KEY, key, rng=random.Random(5))


def points(vk):
    return [c.point for c in vk.comm_selectors + vk.comm_s_sigma]


def test_synthesize_draws_the_srs_and_caches_the_key(keys):
    (key, vk), (key2, vk2), files = keys
    n = key.circuit.circuit.compile().n
    assert n == 256
    srs = key.plonk_pk.srs
    assert srs.max_degree == n + 5
    tau = random.Random(SRS_SEED).randrange(1, R_MOD)
    assert srs.powers_g1[1] == srs.powers_g1[0].mul_scalar(tau)
    assert files == [f"pk_torch_plonk_ecb_16_v{api.PLONK_KEY_VERSION}"
                     f"_srs{n + 5}_{api._srs_digest(srs)}.pkl",
                     f"srs_bls377_v2_d{n + 5}.npz"]
    assert set(key.setup_times) == {"template", "srs", "index"}
    assert key.device == torch.device("cpu") and key._prover is not None
    assert key.plonk_pk.vk is vk and vk.num_public == 128
    assert points(vk2) == points(vk)
    assert (vk2.n, vk2.omega, vk2.ks, vk2.kzg_vk) == (
        vk.n, vk.omega, vk.ks, vk.kzg_vk)


def test_preprocessing_on_the_device_equals_host_setup(keys, host_pk):
    (_key, vk), _loaded, _files = keys
    want = host_pk.vk
    assert points(vk) == points(want)
    assert (vk.n, vk.omega, vk.ks, vk.num_public, vk.kzg_vk) == (
        want.n, want.omega, want.ks, want.num_public, want.kzg_vk)


def test_zk_off_equals_the_host_prover_and_draws_nothing(keys, host_pk):
    (key, vk), _loaded, _files = keys
    got = api.encrypt(MSG, KEY, key, rng=NoDraws(), zk=False)
    toy = key.circuit
    want = backend.prove(host_pk, toy.assign(MSG, KEY),
                         toy.public_values(CT), toy.circuit, rng=ZeroDraws())
    assert got == want
    assert api.verify_encryption(vk, got, CT)


def test_a_seeded_proof_keeps_todays_draws(keys, host_pk, seeded):
    (key, _vk), _loaded, _files = keys
    toy = key.circuit
    public = toy.public_values(CT)
    direct = key._prover.prove(toy.assign(MSG, KEY), public, toy.circuit,
                               rng=random.Random(5))
    assert api.serialize_proof(direct) == api.serialize_proof(seeded)
    assert backend.prove(host_pk, toy.assign(MSG, KEY), public, toy.circuit,
                         rng=random.Random(5)) == seeded


def test_a_cached_key_proves_byte_equal(keys, seeded):
    _fresh, (key2, _vk2), _files = keys
    again = api.encrypt(MSG, KEY, key2, rng=random.Random(5))
    assert api.serialize_proof(again) == api.serialize_proof(seeded)


def test_the_codec_is_the_references(seeded):
    data = api.serialize_proof(seeded)
    assert len(data) == ref_proof.SIZE == 636
    assert data[:12] == b"ZKAESPLK" + (1).to_bytes(4, "little")
    assert ref_proof.serialize(ref_proof.parse(data)) == data
    back = api.deserialize_proof(data)
    assert back == seeded
    assert api.serialize_proof(back) == data
    for bad in (data[:-1], data + b"\0",
                data[:8] + (2).to_bytes(4, "little") + data[12:]):
        with pytest.raises(SerializationError):
            api.deserialize_proof(bad)


def test_a_proof_verifies_under_both_verifiers(keys, seeded):
    (_key, vk), _loaded, _files = keys
    ref_key = derive_key(CiphertextPairs(RefPlonkCircuit).circuit.compile(),
                         SRS_SEED)
    parsed = ref_proof.parse(api.serialize_proof(seeded))
    public = api.bits_lsb_first(CT)
    assert api.verify_encryption(vk, seeded, CT)
    assert ref_verify(ref_key, public, parsed)
    flipped = bytearray(CT)
    flipped[3] ^= 0x10
    assert not api.verify_encryption(vk, seeded, bytes(flipped))
    assert not ref_verify(ref_key, api.bits_lsb_first(bytes(flipped)),
                          parsed)


def test_encrypt_batch_proves_in_turn_from_seeds(keys, monkeypatch):
    (key, _vk), _loaded, _files = keys
    calls = []

    def record(assignment, public, circuit, rng=None, zk=True):
        assert circuit is key.circuit.circuit
        calls.append((assignment(), public, rng.getrandbits(64), zk))
        return len(calls)

    monkeypatch.setattr(key._prover, "prove", record)
    msgs = [MSG, bytes(16)]
    assert api.encrypt_batch(msgs, KEY, key, rng=random.Random(9),
                             zk=False) == [1, 2]
    seeds = random.Random(9)
    seeds = [seeds.randrange(1 << 62) for _ in msgs]
    assert calls == [
        (key.circuit.assign(m, KEY),
         api.bits_lsb_first(api.compute_ciphertext(m, KEY)),
         random.Random(s).getrandbits(64), False)
        for m, s in zip(msgs, seeds)]


@pytest.mark.parametrize("length, mode, system", [
    (32, "ecb", "plonk"), (16, "cbc", "plonk"), (16, "ecb", "groth16")],
    ids=["32-bytes", "cbc", "unknown-system"])
def test_synthesize_keys_refuses(length, mode, system):
    with pytest.raises(InvalidInputError):
        api.synthesize_keys(length, random.Random(1), mode=mode,
                            proof_system=system, device="cpu")


def test_encrypt_refuses_what_a_plonk_key_cannot_prove(keys):
    (key, vk), _loaded, _files = keys
    for kwargs in ({"iv": bytes(16)},
                   {"mesh": make_mesh(devices=[torch.device("cpu")])}):
        with pytest.raises(InvalidInputError):
            api.encrypt(MSG, KEY, key, **kwargs)
    with pytest.raises(InvalidInputError):
        api.encrypt(MSG[:15], KEY, key)
    with pytest.raises(InvalidInputError):
        api.encrypt_batch([MSG], KEY, key, mesh=make_mesh(
            devices=[torch.device("cpu")]))
    with pytest.raises(InvalidInputError):
        api.verify_encryption(vk, None, CT, iv=bytes(16))
