"""The port's forward step (`entry.py`) against the JAX package's
`__graft_entry__.entry()`, with zero tolerance: the ciphertext bits of the
16-byte template's witness fill and the R1CS residual max |Az o Bz - Cz|.

Both templates are built once, in a cache directory of this module's own,
and the JAX forward is jitted once on the CPU; every case reuses them. A
flipped witness bit (an S-box or xor variable of round 1, a key-schedule
variable, a ciphertext variable) makes the residual non-zero, equal to a
numpy reference computed from the template's own rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from aes_zero_knowledge_proof_circuit_tpu.utils.config import (
    CONFIG as JAX_CONFIG,
)
from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch import entry as E
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.aes_host import encrypt_ecb
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from tests import fips197_vectors as fips
from tests.torch_threads import one_torch_thread  # noqa: F401

PAIRS = {
    "fips197": (fips.PLAINTEXT, fips.KEY),
    "zeros": (bytes(16), bytes(16)),
    "ones": (b"\xff" * 16, b"\xff" * 16),
    "seeded": tuple(np.random.default_rng(2026).integers(
        0, 256, 16, dtype=np.uint8).tobytes() for _ in range(2)),
}


def bits(data: bytes) -> np.ndarray:
    return np.asarray(api.bits_lsb_first(data), np.int32)


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """(the port's forward on the CPU, the JAX forward jitted on the CPU,
    the port's template), both packages' templates cached in this module's
    own directory, which stays both packages' cache while its tests run."""
    cache = str(tmp_path_factory.mktemp("cache"))
    old = api.CONFIG.cache_dir, JAX_CONFIG.cache_dir
    api.CONFIG.cache_dir = JAX_CONFIG.cache_dir = cache
    try:
        port, _args = E.entry(device="cpu")
        jax_forward, _jax_args = graft.entry()
        yield port, jax.jit(jax_forward), api._template_cached(16)
    finally:
        api.CONFIG.cache_dir, JAX_CONFIG.cache_dir = old


@pytest.fixture(scope="module")
def tampering(forwards):
    """The port's COO triples on the CPU, numpy (row, column, signed value)
    arrays of A, B and C read from the template's own rows, and the
    template's stage log as {stage: witness count after it}."""
    _port, _jax, tpl = forwards
    ref = []
    for rows in (tpl.r1cs.a_rows, tpl.r1cs.b_rows, tpl.r1cs.c_rows):
        entries = [(i, c, v if v < R_MOD // 2 else v - R_MOD)
                   for i, row in enumerate(rows) for c, v in row.items()]
        ref.append(tuple(np.asarray(col, np.int64) for col in zip(*entries)))
    stages = {name: stats["num_witness_variables"]
              for name, stats in tpl.stage_log}
    return E.coo_on(tpl.r1cs, "cpu"), ref, stages


def numpy_residual(ref, z: np.ndarray, num_constraints: int) -> int:
    products = []
    for rows, cols, vals in ref:
        acc = np.zeros(num_constraints, np.int64)
        np.add.at(acc, rows, vals * z[cols].astype(np.int64))
        products.append(acc)
    a, b, c = products
    return int(np.abs(a * b - c).max())


@pytest.mark.parametrize("pair", list(PAIRS))
def test_forward_equals_the_jax_entry_and_the_aes_oracle(forwards, pair):
    port, jax_forward, _tpl = forwards
    message, key = PAIRS[pair]
    ct_bits, residual = port(torch.from_numpy(bits(message)),
                             torch.from_numpy(bits(key)))
    jax_ct, jax_residual = jax_forward(jnp.asarray(bits(message)),
                                       jnp.asarray(bits(key)))
    assert ct_bits.dtype == torch.int32 and ct_bits.shape == (128,)
    np.testing.assert_array_equal(ct_bits.numpy(), np.asarray(jax_ct))
    np.testing.assert_array_equal(ct_bits.numpy(),
                                  bits(bytes(encrypt_ecb(message, key))))
    assert int(residual) == 0 and int(jax_residual) == 0
    if pair == "fips197":
        assert bytes(encrypt_ecb(message, key)) == fips.EXPECTED_OUTPUT


def test_example_arguments_are_zero_bits(forwards):
    """entry()'s example arguments, like the JAX version's: [128] zero bits,
    whose forward is the zero block's ciphertext with residual 0."""
    port, args = E.entry(device="cpu")
    assert all(a.dtype == torch.int32 and a.shape == (128,)
               and not a.any() for a in args)
    ct_bits, residual = port(*args)
    assert ct_bits.tolist() == api.bits_lsb_first(
        bytes(encrypt_ecb(bytes(16), bytes(16))))
    assert int(residual) == 0


def stage_middle(stages: dict, before: str, after: str, num_instance: int):
    """The z index of the witness variable halfway through a stage."""
    return num_instance + (stages[before] + stages[after]) // 2


@pytest.mark.parametrize("where", ["round1_sbox_xor", "key_schedule",
                                   "ciphertext"])
def test_flipped_witness_bit_gives_a_nonzero_residual(forwards, tampering,
                                                      where):
    _port, _jax, tpl = forwards
    coo, ref, stages = tampering
    n_inst, n_cons = tpl.r1cs.num_instance, tpl.r1cs.num_constraints
    position = {
        "round1_sbox_xor": stage_middle(
            stages, "block 0: after add_round_key round 0",
            "block 0: after round 1", n_inst),
        "key_schedule": stage_middle(
            stages, "After allocating the secret key",
            "After deriving the round keys", n_inst),
        "ciphertext": 1 + 77,
    }[where]
    message, key = PAIRS["fips197"]
    evaluator = api.WitnessEvaluator(tpl.plan, "cpu")
    z = evaluator.evaluate({"message": bits(message), "key": bits(key)})
    assert int(E.r1cs_residual(coo, z, n_cons)) == 0
    assert numpy_residual(ref, z.numpy(), n_cons) == 0
    z[position] = 1 - z[position]
    residual = int(E.r1cs_residual(coo, z, n_cons))
    assert residual > 0
    assert residual == numpy_residual(ref, z.numpy(), n_cons)


def test_entry_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no device the forward step is built on the card; without one it
    raises before any setup work and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_setup(*args, **kwargs):
        raise AssertionError("entry() built a template without a card")

    monkeypatch.setattr(api, "_template_cached", no_setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
