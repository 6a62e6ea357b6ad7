"""The port's 8-bit bucket-scan MSM (ops/msm_pallas.py through
ops/msm_device.py, plain K4 version) against the host Pippenger and host
window sums, and against the JAX msm_pallas in interpret mode (slow).
Inputs come from numpy seeds; equality is of affine points, zero
tolerance. The cases of tests/test_msm_pallas.py come first, then the
landing's edge cases: n not a power of two, a window of zero digits, a
window of one bucket, equal and opposite points in one bucket, and the
tree levels' bookkeeping and branches (P + P, P + (-P), infinity, the odd
carry) at chunk geometries that force every level."""

import functools

import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_host
from aes_zero_knowledge_proof_circuit_tpu.ops import curve_host as ch
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg as tkzg
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.msm import xyzz_to_affine
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import pack_points
from tests.torch_threads import one_torch_thread  # noqa: F401


def xy(p):
    """An affine point of either package as plain integers."""
    return None if p.inf else (int(p.x), int(p.y))


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
    assert xy(device_msm(pts, scalars, lanes)) == xy(msm_host.msm(pts,
                                                                  scalars))


def test_window_sums_match_host():
    pts, scalars = msm_pallas_case(67)
    pt = MD.points_from_packed(pack_points(pts), "cpu")
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    got = xyzz_to_affine(MP.msm_parts(pt, digits, lanes=8)[1])
    want = [msm_host.msm(pts, [(s >> (8 * w)) & 0xFF for s in scalars])
            for w in range(MP.WINDOWS)]
    assert [xy(p) for p in got] == [xy(p) for p in want]


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
        assert xy(device_msm(pts, scalars, lanes)) == xy(want)


def test_all_zero_scalars_and_empty():
    pts = rand_points(7, 9)
    assert device_msm(pts, [0] * 9, lanes=4).inf
    assert MD.msm([], [], "cpu").inf


def test_landing_bookkeeping():
    """idx lists the points of every nonzero digit in (window, digit)
    order, stable within a digit; first[l] counts ceil(m / 2^l) partials of
    each bucket w * 256 + d - 1 at level l; the levels run while some
    bucket has two partials and a thread has MIN_CHUNK adds; the geometry
    covers each level's adds in whole blocks."""
    scalars = rand_ints(8, 37, 1 << 24)
    scalars[:9] = [0] * 9
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    for lanes in (1, 4, None):
        plan = MP.land(digits, lanes=lanes)
        assert plan.lanes == (lanes or MP.LANES)
        want_idx, m = [], np.zeros(MP.WINDOWS * MP.BUCKETS, np.int64)
        for w in range(MP.WINDOWS):
            for d in range(1, MP.BUCKETS):
                pts = [i for i, s in enumerate(scalars)
                       if (s >> (8 * w)) & 0xFF == d]
                want_idx += pts
                m[w * MP.BUCKETS + d - 1] = len(pts)
        assert plan.idx.tolist() == want_idx
        assert plan.first.shape == (plan.levels + 1, m.size + 1)
        for lvl in range(plan.levels + 1):
            per = -(-m // (1 << lvl))
            assert plan.first[lvl].tolist() == [0] + np.cumsum(per).tolist()
        most = lambda lvl: int(-(-m // (1 << lvl)).max())
        assert plan.levels >= 1
        for lvl in range(1, plan.levels):
            assert most(lvl) > 1
            assert plan.geometry[lvl, 1] >= MP.MIN_CHUNK
        last = plan.levels
        next_items = int((-(-m // (1 << (last + 1)))).sum())
        assert most(last) <= 1 or -(-next_items // plan.lanes) < MP.MIN_CHUNK
        for lvl, (items, chunk, threads) in enumerate(plan.geometry):
            assert items == int(plan.first[lvl + 1][-1])
            assert chunk == -(-items // plan.lanes)
            assert threads % MP.LEVEL_BLOCK == 0
            assert threads * chunk >= items > (threads - MP.LEVEL_BLOCK) * chunk
        assert plan.merge_passes == max(0, most(last) - 1).bit_length()
        assert torch.equal(plan.merge_prefix,
                           MP.merge_plan(plan.first[last], plan.merge_passes))
    assert MP.land(digits, lanes=1).levels == max(0, int(m.max()) - 1) \
        .bit_length()


def tree_case():
    """40 points whose scalars share their low byte, so that window 0 is
    one bucket of 40 pairs in index order: Q four times (P + P at levels 0
    and 1), then Q, Q, -Q, -Q (2Q + (-2Q) cancels at level 1), an infinity
    point, -R beside R (P + (-P) at level 0). The other windows hold buckets
    of one pair, and the top window 5-bit digits."""
    pts = rand_points(5, 40)
    q = pts[0]
    pts[1:6] = [q] * 5
    pts[6] = pts[7] = q.neg()
    pts[8] = ch.g1_infinity()
    pts[11] = pts[10].neg()
    scalars = [(s & ~0xFF) | 0x33 for s in rand_ints(6, 40)]
    return pts, scalars


@pytest.mark.parametrize("lanes", [1, 512, None],
                         ids=["all_levels", "lanes512", "lanes_default"])
def test_tree_branches_match_host(lanes):
    """Every kind of a level's item (copy, add, P + P, P + (-P)) is
    reached, and the MSM and window sums equal the host's."""
    pts, scalars = tree_case()
    pt = MD.points_from_packed(pack_points(pts), "cpu")
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    plan = MP.land(digits, lanes=lanes)
    stats = {}
    point, wsums = MP.plain_scan_msm(pt, plan, stats)
    if lanes == 1:
        assert plan.merge_passes == 0 and plan.levels == 6   # 40 -> 1
    else:
        assert plan.levels >= 1 and plan.merge_passes >= 1
    assert all(stats[k] > 0 for k in ("copy", "add", "dbl", "cancel"))
    want = [msm_host.msm(pts, [(s >> (8 * w)) & 0xFF for s in scalars])
            for w in range(MP.WINDOWS)]
    assert [xy(p) for p in xyzz_to_affine(wsums)] == [xy(p) for p in want]
    assert xy(xyzz_to_affine(point)[0]) == xy(msm_host.msm(pts, scalars))


@pytest.mark.parametrize("lanes", [1, None], ids=["all_levels",
                                                  "lanes_default"])
def test_edge_points_reach_every_branch(lanes):
    """edge_inputs.k4_edge_points (the card checks' bucket of equal,
    opposite and infinity points) edits the points as it says, and with the
    card checks' scalars (low byte 0x5A from index 1) its bucket reaches
    every kind of item; the MSM equals the host's."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import edge_inputs

    n = 16
    pts = rand_points(9, n)
    host = list(pts)
    host[2:7] = [pts[1]] * 5
    host[7] = host[8] = pts[1].neg()
    host[9] = ch.g1_infinity()
    host[11] = pts[10].neg()
    got = edge_inputs.k4_edge_points(
        MD.points_from_packed(pack_points(pts), "cpu"), n)
    assert torch.equal(got, MD.points_from_packed(pack_points(host), "cpu"))
    scalars = [0] + [(s & ~0xFF) | 0x5A for s in rand_ints(10, n - 1)]
    digits = torch.from_numpy(MD.scalars_to_digit_limbs(scalars)
                              .astype(np.int32))
    stats = {}
    point, _ = MP.plain_scan_msm(got, MP.land(digits, lanes=lanes), stats)
    assert all(stats[k] > 0 for k in MP.KINDS)
    assert xy(xyzz_to_affine(point)[0]) == xy(msm_host.msm(host, scalars))


def test_level_y_zero_doubles_to_infinity():
    """P + P with y = 0 (the 2-torsion point (-1, 0), on the curve but
    outside G1) is infinity, as in the kernel; a lone input is copied."""
    fq = MP.FQ
    p = torch.stack([fq.from_ints([fq.modulus - 1], "cpu")[0],
                     torch.zeros(fq.L, dtype=torch.int32)])
    src = torch.stack([p, p, p])
    stats = {}
    out = MP._plain_level(src, None, torch.tensor([0, 2, 3]),
                          torch.tensor([0, 1, 2]), stats)
    assert not out[0].any() and torch.equal(out[1], p)
    assert stats == {"copy": 1, "add": 0, "dbl": 0, "cancel": 1}


@pytest.mark.parametrize("items,lanes", [(1, MP.LANES), (16_400_000, 1 << 17),
                                         (16_400_000, 1 << 16), (1000, 8)])
def test_level_geometry(items, lanes):
    """A level's adds fill whole blocks of at most `lanes` threads (one
    block when lanes is smaller), each thread `chunk` adds."""
    chunk, threads = MP.level_geometry(items, lanes)
    assert chunk == -(-items // lanes)
    assert threads % MP.LEVEL_BLOCK == 0
    assert threads <= max(lanes, MP.LEVEL_BLOCK)
    assert threads * chunk >= items > (threads - MP.LEVEL_BLOCK) * chunk


def test_device_points_and_commit_msm_fn():
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native(63, random.Random(3))
    coeffs = rand_ints(9, 20)
    fn = functools.partial(MD.msm, device="cpu")
    got, _ = tkzg.commit(srs, coeffs, offset=5, msm_fn=fn)
    want = msm_host.msm([ch.g1_point(p.x, p.y) for p in srs.powers_g1[5:25]],
                        coeffs)
    assert xy(got.point) == xy(want)
    dp = MD.DevicePoints(MD.points_from_packed(srs.powers_g1.packed, "cpu"))
    assert xy(dp.msm(coeffs, offset=5)) == xy(want)
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
    assert xy(device_msm(pts, scalars, lanes=8)) == xy(want)
