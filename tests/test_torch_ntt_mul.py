"""The port's Fq column multiplier (ops/msm_ntt_mul.py, plain K5 version)
against the JAX ntt_mul in interpret mode on the same columns and against
host integers: the three cases of tests/test_ntt_mul.py, compared as
canonical integers (the port writes canonical digits, the JAX module values
below 1.1q), zero tolerance."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_ntt_mul as JM
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_ntt_mul as NM
from tests.torch_threads import one_torch_thread  # noqa: F401


def both(a: np.ndarray, b: np.ndarray, blk: int):
    """(port, JAX) products of the same columns, as canonical ints."""
    port = NM.ntt_mul(torch.from_numpy(a), torch.from_numpy(b))
    ref = JM.ntt_mul(jnp.asarray(a), jnp.asarray(b), blk=blk,
                     interpret=jax.default_backend() != "tpu")
    return port, NM.cols_to_ints(port), JM.cols_to_ints(np.asarray(ref))


def test_conversions_match_jax():
    vals = [0, 1, Q_MOD - 1, 2**376] + [random.Random(3).randrange(Q_MOD)
                                        for _ in range(12)]
    for mont in (True, False):
        cols = NM.ints_to_cols(vals, mont=mont)
        np.testing.assert_array_equal(cols, JM.ints_to_cols(vals, mont=mont))
        assert NM.cols_to_ints(cols, mont=mont) == vals
    redundant = NM.ints_to_cols(vals) + 256
    redundant[1:] -= 1
    assert NM.cols_to_ints(redundant) == JM.cols_to_ints(redundant)


def test_ntt_mul_matches_jax_and_host():
    r = random.Random(7)
    vals_a = [0, 1, Q_MOD - 1, 2**376] + [r.randrange(Q_MOD)
                                          for _ in range(28)]
    vals_b = [r.randrange(Q_MOD) for _ in range(32)]
    vals_b[0] = 0
    vals_b[1] = Q_MOD - 1
    port, got, ref = both(NM.ints_to_cols(vals_a), NM.ints_to_cols(vals_b),
                          blk=32)
    assert got == ref == [x * y % Q_MOD for x, y in zip(vals_a, vals_b)]
    # canonical output: every digit a byte, rows 48-63 zero
    assert int(port.min()) >= 0 and int(port.max()) <= 255
    assert not bool(port[48:].any())


def test_ntt_mul_chained_matches_jax():
    """Outputs fed back as inputs for four rounds, on both sides."""
    r = random.Random(11)
    vals = [r.randrange(Q_MOD) for _ in range(16)]
    cur = torch.from_numpy(NM.ints_to_cols(vals))
    ref = jnp.asarray(JM.ints_to_cols(vals))
    want = list(vals)
    for _ in range(4):
        cur = NM.ntt_mul(cur, cur)
        ref = JM.ntt_mul(ref, ref, blk=16,
                         interpret=jax.default_backend() != "tpu")
        want = [w * w % Q_MOD for w in want]
        assert NM.cols_to_ints(cur) == JM.cols_to_ints(np.asarray(ref)) \
            == want


def test_ntt_mul_fold_band_inputs_match_jax():
    """Values above q with digits up to DIGIT_BAND, as the scan kernel's
    adds and subtractions leave them."""
    r = random.Random(13)
    n = 8
    base = NM.ints_to_cols([r.randrange(Q_MOD) for _ in range(n)])
    q_dig = np.zeros((NM.PAD_IN, 1), np.int32)
    q_dig[:NM.DIGITS, 0] = np.frombuffer(Q_MOD.to_bytes(NM.DIGITS, "little"),
                                         np.uint8)
    shifted = base + q_dig
    carry = shifted >> 8
    shifted = (shifted & 255) + np.concatenate(
        [np.zeros((1, n), np.int32), carry[:-1]], axis=0)
    assert shifted.max() <= NM.DIGIT_BAND
    b = NM.ints_to_cols([r.randrange(Q_MOD) for _ in range(n)])
    _port, got, ref = both(shifted, b, blk=8)
    want = [x * y % Q_MOD for x, y in zip(NM.cols_to_ints(base),
                                          NM.cols_to_ints(b))]
    assert got == ref == want


def test_ntt_mul_rejects_digits_outside_the_band():
    a = torch.from_numpy(NM.ints_to_cols([5, 7]))
    bad = a.clone()
    bad[3, 1] = NM.DIGIT_BAND + 1
    with pytest.raises(ValueError, match="outside"):
        NM.ntt_mul(a, bad)
    with pytest.raises(ValueError, match="64, N"):
        NM.ntt_mul(a[:50], a[:50])
