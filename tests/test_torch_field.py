"""Port field engine (plain K1 versions) vs the JAX F32Ops engine and the
Pallas multiply in interpret mode; convert.py round trips.

Field arithmetic is exact, so every comparison is at canonical integers with
zero tolerance. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
    digits_to_ints,
    fq_f32,
    fr_f32,
    ints_to_digits,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD, R_MOD
from aes_zero_knowledge_proof_circuit_tpu.ops.pallas_field import pallas_mul
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fq_ops, fr_ops
from tests.torch_threads import one_torch_thread  # noqa: F401

INTERP = jax.default_backend() != "tpu"
FIELDS = {"fr": (fr_ops, fr_f32, R_MOD), "fq": (fq_ops, fq_f32, Q_MOD)}


def rand_ints(seed: int, n: int, mod: int):
    """n values mod `mod` from a numpy seed, plus the edges 0, 1, mod - 1."""
    raw = np.random.default_rng(seed).bytes(n * 64)
    vals = [int.from_bytes(raw[64 * i: 64 * i + 64], "little") % mod
            for i in range(n)]
    return vals + [0, 1, mod - 1]


@pytest.mark.parametrize("which", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_plain_k1_matches_f32_engine(which, op):
    port, ref, mod = FIELDS[which]
    f, g = port(), ref()
    av = rand_ints(1, 64, mod)
    bv = rand_ints(2, 64, mod)[::-1]
    got = getattr(f, op)(f.from_ints(av, "cpu"), f.from_ints(bv, "cpu"))
    want = getattr(g, op)(jnp.asarray(ints_to_digits(g, av)),
                          jnp.asarray(ints_to_digits(g, bv)))
    assert f.to_ints(got) == digits_to_ints(g, want)


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_plain_mul_matches_pallas_interpret(which):
    port, ref, mod = FIELDS[which]
    f, g = port(), ref()
    av = rand_ints(3, 16, mod)
    bv = rand_ints(4, 16, mod)
    want = pallas_mul(g, jnp.asarray(ints_to_digits(g, av)),
                      jnp.asarray(ints_to_digits(g, bv)), interpret=INTERP)
    got = f.plain_mul(f.from_ints(av, "cpu"), f.from_ints(bv, "cpu"))
    assert f.to_ints(got) == digits_to_ints(g, want)
    assert f.to_ints(got) == [x * y % mod for x, y in zip(av, bv)]


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_broadcast_row_and_neg_square(which):
    port, _ref, mod = FIELDS[which]
    f = port()
    av = rand_ints(5, 32, mod)
    s = av[3]
    a = f.from_ints(av, "cpu")
    srow = f.from_ints([s], "cpu")
    assert f.to_ints(f.mul(a, srow)) == [x * s % mod for x in av]
    assert f.to_ints(f.mul(srow, a)) == [x * s % mod for x in av]
    assert f.to_ints(f.sub(srow, a)) == [(s - x) % mod for x in av]
    assert f.to_ints(f.neg(a)) == [(-x) % mod for x in av]
    assert f.to_ints(f.square(a)) == [x * x % mod for x in av]


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_batch_inv_inv_and_is_zero(which):
    port, ref, mod = FIELDS[which]
    f, g = port(), ref()
    av = rand_ints(6, 40, mod)
    a = f.from_ints(av, "cpu")
    want = digits_to_ints(g, g.batch_inv(jnp.asarray(ints_to_digits(g, av))))
    assert f.to_ints(f.batch_inv(a)) == want
    assert want == [pow(x, -1, mod) if x else 0 for x in av]
    assert f.to_ints(f.inv(a[:3])) == [pow(x, -1, mod) for x in av[:3]]
    assert f.is_zero(a).tolist() == [x == 0 for x in av]
    pick = f.select(torch.tensor([x % 2 == 0 for x in av]), a, f.neg(a))
    assert f.to_ints(pick) == [x if x % 2 == 0 else (-x) % mod for x in av]


def test_canonical_limbs_and_small_ints():
    f, g = fr_ops(), fr_f32()
    av = rand_ints(7, 20, R_MOD)
    std = f.to_canonical_limbs(f.from_ints(av, "cpu"))
    assert f.to_ints(std, mont=False) == av
    # the JAX engine's canonical 16-bit limbs of the same standard values
    ref16 = np.asarray(g.to_canonical_limbs(g.mul(
        jnp.asarray(ints_to_digits(g, av)),
        jnp.zeros((g.D,), jnp.float32).at[0].set(1.0))))
    got16 = std.numpy().view(np.uint16).reshape(len(av), 16)
    np.testing.assert_array_equal(got16.astype(np.uint32), ref16[:, :16])
    small = [0, 1, -1, 5, -(1 << 23), (1 << 40) + 3, -(1 << 62)]
    got = f.from_small(torch.tensor(small, dtype=torch.int64))
    assert f.to_ints(got) == [v % R_MOD for v in small]


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_convert_round_trip_from_engine_digits(which):
    """JAX engine outputs (redundant digit band) -> port limbs -> digits."""
    _port, ref, mod = FIELDS[which]
    g = ref()
    av = rand_ints(8, 24, mod)
    bv = rand_ints(9, 24, mod)
    # sub/mul outputs sit anywhere in the engine's fold band
    dig = np.asarray(g.sub(jnp.asarray(ints_to_digits(g, av)),
                           jnp.asarray(ints_to_digits(g, bv))))
    want = [(x - y) % mod for x, y in zip(av, bv)]
    if which == "fr":
        port_t = convert.fr_from_f32_digits(dig, "cpu")
        back = convert.fr_to_f32_digits(port_t)
        assert fr_ops().to_ints(port_t) == want
    else:
        port_t = convert.fq_from_f32_digits(dig, "cpu")
        back = convert.fq_to_f32_digits(port_t)
        assert fq_ops().to_ints(port_t) == want
    assert digits_to_ints(g, back) == want
    # the way back is canonical bytes: digits in [0, 256)
    assert back.min() >= 0 and back.max() < 256


def test_points_from_packed_are_montgomery_affine():
    from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
        g1_generator,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        pack_points,
    )

    g = g1_generator()
    pts = [g, g.double(), g.mul_scalar(12345), g.add(g.neg())]
    dev = convert.points_from_packed(pack_points(pts), "cpu")
    fq = fq_ops()
    assert fq.to_ints(dev[:3, 0]) == [p.x for p in pts[:3]]
    assert fq.to_ints(dev[:3, 1]) == [p.y for p in pts[:3]]
    assert pts[3].inf and not dev[3].any()


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on a device without a kernel raises."""
    f = fr_ops()
    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        f.mul(a, a)
    with pytest.raises(ValueError):
        f.add(torch.zeros((4, 7), dtype=torch.int32),
              torch.zeros((4, 7), dtype=torch.int32))
