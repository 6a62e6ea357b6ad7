"""The reference: its AES-128 on FIPS-197's vectors, its circuit against
the port's, its key against the port's indexer, its proof bytes and its
verifier against the port's proofs (on the toy circuit, on the CPU)."""

import pytest

from zkbench.ref import aes
from zkbench.ref import proof as ref_proof
from zkbench.ref.field import G, R_MOD, add, in_subgroup, mul, neg, on_curve
from zkbench.ref.verify import verify
from zkbench.tests import toy

# FIPS-197 Appendix B and C.1
VECTORS = [
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
]


@pytest.mark.parametrize("key, plain, cipher", VECTORS)
def test_aes_fips197(key, plain, cipher):
    out = aes.encrypt_ecb(bytes.fromhex(plain), bytes.fromhex(key))
    assert out.hex() == cipher


def test_aes_ecb_blocks_and_bits():
    key = bytes.fromhex(VECTORS[0][0])
    block = bytes.fromhex(VECTORS[0][1])
    two = aes.encrypt_ecb(block * 2, key)
    assert two == bytes.fromhex(VECTORS[0][2]) * 2
    assert aes.bits_lsb_first(b"\x01\x80") == [1] + [0] * 14 + [1]
    assert aes.SBOX[0] == 0x63 and aes.SBOX[0x53] == 0xED
    with pytest.raises(ValueError):
        aes.encrypt_ecb(b"short", key)


def test_group_arithmetic():
    assert on_curve(G) and in_subgroup(G)
    assert mul(G, R_MOD) is None
    assert add(mul(G, 5), mul(G, 7)) == mul(G, 12)
    assert add(G, neg(G)) is None
    assert mul(G, 2) == add(G, G)


def test_the_circuit_copy_matches_the_port():
    from aes_zero_knowledge_proof_circuit_tpu_torch.models import (
        aes_circuit as port)
    from zkbench.ref.circuit import aes_circuit as ref
    # the builders are frozen copies: same source but for import paths
    strip = lambda text: [l for l in text.splitlines()  # noqa: E731
                          if not l.startswith("from ..")]
    import inspect
    assert strip(inspect.getsource(port)) == strip(inspect.getsource(ref))


@pytest.fixture(scope="module")
def toy_pair():
    cell = toy.toy_cell()
    return toy.ToyProgram(cell.config), toy.ToyReference(cell.config)


def test_reference_key_equals_the_port_index(toy_pair):
    program, reference = toy_pair
    vk = program.prover.pk.vk
    key = reference.key()
    assert [(c.point.x, c.point.y) for c in vk.index_comms] == \
        key.index_comms
    assert (vk.log_n, vk.log_x, vk.num_instance, vk.log_ks,
            vk.max_degree) == (key.log_n, key.log_x, key.num_instance,
                               key.log_ks, key.max_degree)
    assert (vk.kzg_vk.gamma_g.x, vk.kzg_vk.gamma_g.y) == key.gamma_g


def test_verifier_accepts_a_proof_and_refuses_tampering(toy_pair):
    program, reference = toy_pair
    message, key = b"\x5a\xc3", bytes(range(16))
    proof = program._prove(message, key, 11)
    data = program.serialize(proof)
    parsed = ref_proof.parse(data)
    assert ref_proof.serialize(parsed) == data
    instance = reference.instance(message, key)
    assert verify(reference.key(), instance, parsed)
    for i in (1, len(instance) - 1):
        bad = list(instance)
        bad[i] ^= 1
        assert not verify(reference.key(), bad, parsed)
    # an evaluation or an opening changed after the proof was made
    parsed.evals_beta1[2] = (parsed.evals_beta1[2] + 1) % R_MOD
    assert not verify(reference.key(), instance, parsed)
    parsed = ref_proof.parse(data)
    w, r = parsed.openings[1]
    parsed.openings[1] = (w, (r + 1) % R_MOD)
    assert not verify(reference.key(), instance, parsed)


def test_proof_bytes_refused(toy_pair):
    program, _ = toy_pair
    data = program.serialize(program._prove(b"\x01\x02", bytes(16), 12))
    with pytest.raises(ref_proof.ProofBytesError):
        ref_proof.parse(data[:-1])
    with pytest.raises(ref_proof.ProofBytesError):
        ref_proof.parse(data + b"\x00")
    with pytest.raises(ref_proof.ProofBytesError):
        ref_proof.parse(b"NOTAPROOF" + data[9:])
    bad = bytearray(data)
    bad[12] ^= 0x01                      # the x of the first commitment
    try:
        parsed = ref_proof.parse(bytes(bad))
    except ref_proof.ProofBytesError:
        return
    assert ref_proof.serialize(parsed) == bytes(bad)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('aes_zero_knowledge_proof_circuit_tpu_torch', 'jax',"
            " 'aes_zero_knowledge_proof_circuit_tpu', 'torch'):\n"
            "    sys.modules[m] = None\n"
            "import zkbench.reference, zkbench.judge, zkbench.ref.verify\n"
            "import zkbench.ref.circuit.aes_circuit, zkbench.faults\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(toy.manifest.ROOT))
    assert out.stdout.strip() == "ok", out.stderr
