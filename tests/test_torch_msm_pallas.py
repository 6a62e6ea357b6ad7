"""The port's 8-bit bucket-scan MSM (ops/msm_pallas.py through
ops/msm_device.py, plain K4 version) against the host Pippenger and host
window sums, and against the JAX msm_pallas in interpret mode (slow).
Inputs come from numpy seeds; equality is of affine points, zero
tolerance. The cases of tests/test_msm_pallas.py come first, then the
landing's edge cases: fewer points than lanes, n not a power of two, a
window of zero digits, lanes that hold one bucket only, equal and
opposite points in one run."""

import functools

import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import kzg, msm_host
from aes_zero_knowledge_proof_circuit_tpu.ops import curve_host as ch
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.msm import window_points
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import pack_points
from tests.torch_threads import one_torch_thread  # noqa: F401


def rand_ints(seed: int, n: int, bound: int = R_MOD):
    raw = np.random.default_rng(seed).bytes(n * 40)
    return [int.from_bytes(raw[40 * i: 40 * i + 40], "little") % bound
            for i in range(n)]


def rand_points(seed: int, n: int):
    g = ch.g1_generator()
    return [g.mul_scalar(s or 1) for s in rand_ints(seed, n)]


def device_msm(points, scalars, lanes=None):
    pts = MD.points_from_packed(pack_points(points), "cpu")
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    return MD.msm_device(pts, digits, lanes=lanes)


def msm_pallas_case(n: int):
    """The inputs of tests/test_msm_pallas.py at n points: an infinity
    point, zero scalars and a long equal-digit run in the low window."""
    pts = rand_points(n, n)
    scalars = rand_ints(n + 100, n)
    if n == 67:
        pts[7] = ch.g1_infinity()
        scalars[11] = scalars[12] = 0
        for i in range(20, 30):
            scalars[i] = (scalars[i] & ~0xFF) | 0x5A
    return pts, scalars


@pytest.mark.parametrize("lanes", [None, 8], ids=["lanes_default", "lanes8"])
@pytest.mark.parametrize("n", [1, 3, 16, 67])
def test_msm_matches_host(n, lanes):
    pts, scalars = msm_pallas_case(n)
    assert device_msm(pts, scalars, lanes) == msm_host.msm(pts, scalars)


def test_window_sums_match_host():
    pts, scalars = msm_pallas_case(67)
    pt = MD.points_from_packed(pack_points(pts), "cpu")
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    got = window_points(MP.window_sums(pt, digits, lanes=8))
    want = [msm_host.msm(pts, [(s >> (8 * w)) & 0xFF for s in scalars])
            for w in range(MP.WINDOWS)]
    assert got == want


def test_zero_windows_single_bucket_lanes_and_degenerate_runs():
    """Scalars below 2^64 leave windows 8-31 all zero; every scalar shares
    its low byte, so every lane of window 0 holds one bucket; repeated
    points make the scan double (P + P) and opposite points cancel
    (P + (-P)) inside one run."""
    pts = rand_points(5, 40)
    pts[10] = pts[9]
    pts[12] = pts[11].neg()
    scalars = [(s & ~0xFF) | 0x33 for s in rand_ints(6, 40, 1 << 64)]
    want = msm_host.msm(pts, scalars)
    for lanes in (None, 5, 40):
        assert device_msm(pts, scalars, lanes) == want


def test_all_zero_scalars_and_empty():
    pts = rand_points(7, 9)
    assert device_msm(pts, [0] * 9, lanes=4).inf
    assert MD.msm([], [], "cpu").inf


def test_landing_bookkeeping():
    """lane_base counts each lane's (lane, nonzero digit) runs; first
    groups the tails by (window, digit) in slot order."""
    scalars = rand_ints(8, 37, 1 << 24)
    scalars[:9] = [0] * 9
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    plan = MP.land(digits, lanes=4)
    assert (plan.lanes, plan.steps) == (4, 10)
    lane_major = plan.digits.transpose(1, 2).numpy()        # [W, lanes, steps]
    keys = []
    for w in range(MP.WINDOWS):
        want = sorted([(s >> (8 * w)) & 0xFF for s in scalars] + [0] * 3)
        assert lane_major[w].reshape(-1).tolist() == want
        for j in range(plan.lanes):
            runs = sorted(set(d for d in lane_major[w, j].tolist() if d))
            t = w * plan.lanes + j
            assert plan.lane_base[t + 1] - plan.lane_base[t] == len(runs)
            keys += [w * MP.BUCKETS + d - 1 for d in runs]
    assert plan.n_tails == len(keys)
    counts = np.bincount(keys, minlength=MP.WINDOWS * MP.BUCKETS)
    assert plan.first.tolist() == [0] + np.cumsum(counts).tolist()


def test_device_points_and_commit_msm_fn():
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native(63, random.Random(3))
    coeffs = rand_ints(9, 20)
    fn = functools.partial(MD.msm, device="cpu")
    got, _ = kzg.commit(srs, coeffs, offset=5, msm_fn=fn)
    want, _ = kzg.commit(srs, coeffs, offset=5)
    assert got.point == want.point
    dp = MD.DevicePoints(MD.points_from_packed(srs.powers_g1.packed, "cpu"))
    assert dp.msm(coeffs, offset=5) == want.point
    with pytest.raises(ValueError, match="exceeds"):
        dp.slice(60, 5)


@pytest.mark.slow
@pytest.mark.parametrize("n", [3, 67])
def test_msm_matches_jax_msm_pallas(n):
    import jax.numpy as jnp

    from aes_zero_knowledge_proof_circuit_tpu.ops import curve_jax
    from aes_zero_knowledge_proof_circuit_tpu.ops.msm_pallas import msm_pallas

    pts, scalars = msm_pallas_case(n)
    digits = MD.scalars_to_digit_limbs(scalars)
    want = msm_pallas(curve_jax.affine_to_device(pts), jnp.asarray(digits),
                      lanes=8, interpret=True)
    assert device_msm(pts, scalars, lanes=8) == want
