"""Port MSM (plain K3 version) vs the host Pippenger and the native one.

Points come from the native fixed-base generator (SRS-like, random scalars
from numpy seeds); equality is of affine points, zero tolerance."""

import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_host
from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    g1_generator,
    g1_infinity,
    g1_point,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD, R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import curve
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fq_ops, fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.native import native
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    PackedPowers,
    pack_points,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

F = fr_ops()
MAX_N = 1 << 11


def rand_scalars(seed: int, n: int):
    raw = np.random.default_rng(seed).bytes(n * 40)
    return [int.from_bytes(raw[40 * i: 40 * i + 40], "little") % R_MOD
            for i in range(n)]


@pytest.fixture(scope="module")
def packed():
    out = native().g1_powers_fixed_base_packed(g1_generator(),
                                               rand_scalars(1, MAX_N))
    assert out is not None, "native zkhost library unavailable"
    return out


@pytest.mark.parametrize("n", [16, 64, 256, 1000, MAX_N])
def test_msm_matches_host_and_native(packed, n):
    sc = rand_scalars(n, n)
    sc[0] = 0                                   # zero scalar
    pk = packed[:n].copy()
    pk[3] = pk[2]                               # repeated point: P + P
    c = M.window_bits(n)
    sc[2], sc[3] = 3, (1 << c) - 3              # digits +3 and -3: P - P
    sc[5] = R_MOD - 1
    pk[7], sc[7] = pk[6], sc[6]                 # equal pairs in every window
    got = M.msm(M.points_from_packed(pk, "cpu"), F.from_ints(sc, "cpu",
                                                             mont=False))
    assert got == msm_host.msm(list(PackedPowers(pk)), sc)
    u64 = native().pack_scalars(sc)
    assert got == native().g1_msm_packed(pk, u64)


def test_msm_all_zero_and_infinity_points(packed):
    pk = packed[:16].copy()
    pk[4] = 0                                   # the point at infinity
    pts = M.points_from_packed(pk, "cpu")
    zero = F.from_ints([0] * 16, "cpu", mont=False)
    assert M.msm(pts, zero).inf
    sc = rand_scalars(2, 16)
    got = M.msm(pts, F.from_ints(sc, "cpu", mont=False))
    assert got == msm_host.msm(list(PackedPowers(pk)), sc)


@pytest.mark.parametrize("c", [2, 8, 13])
def test_signed_digits_reconstruct_and_match_msm_mxu(c):
    from aes_zero_knowledge_proof_circuit_tpu.ops.msm_mxu import signed_digits

    sc = rand_scalars(3, 64) + [0, 1, R_MOD - 1]
    mags, negs = M.signed_digits(F.from_ints(sc, "cpu", mont=False), c)
    assert int(mags.max()) <= 1 << (c - 1)
    for i, s in enumerate(sc):
        v = sum((-1 if negs[w, i] else 1) * int(mags[w, i]) << (c * w)
                for w in range(mags.shape[0]))
        assert v == s
    if c in (8, 13):
        limbs16 = np.zeros((len(sc), 16), np.uint32)
        for i, s in enumerate(sc):
            limbs16[i] = [(s >> (16 * j)) & 0xFFFF for j in range(16)]
        rb, rn = signed_digits(limbs16, c)
        np.testing.assert_array_equal(mags.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(negs.numpy(), np.asarray(rn))


def test_bucket_runs_group_pairs_by_bucket():
    sc = rand_scalars(4, 50)
    c = 4
    mags, negs = M.signed_digits(F.from_ints(sc, "cpu", mont=False), c)
    idx, neg, offsets = M.bucket_runs(mags, negs, 1 << (c - 1))
    b = 1 << (c - 1)
    for w in range(mags.shape[0]):
        for m in range(b + 1):
            lo, hi = offsets[w * (b + 1) + m], offsets[w * (b + 1) + m + 1]
            got = sorted(idx[lo:hi].tolist())
            want = [i for i in range(50) if int(mags[w, i]) == m]
            assert got == want
            assert all(bool(neg[k]) == bool(negs[w, idx[k]])
                       for k in range(lo, hi))


def _jacobian(points, zs):
    """Host affine points -> port Jacobian (x z^2, y z^3, z); infinity is
    all zeros."""
    rows = [(0, 0, 0) if p.inf else
            (p.x * z * z % Q_MOD, p.y * z * z * z % Q_MOD, z)
            for p, z in zip(points, zs)]
    return tuple(fq_ops().from_ints([r[i] for r in rows], "cpu")
                 for i in range(3))


def _affine(jac):
    out = []
    for x, y, z in zip(*(fq_ops().to_ints(t) for t in jac)):
        if z == 0:
            out.append(g1_infinity())
        else:
            zi = pow(z, -1, Q_MOD)
            out.append(g1_point(x * zi * zi % Q_MOD, y * zi ** 3 % Q_MOD))
    return out


@pytest.mark.parametrize("case", ["distinct", "equal", "opposite"])
def test_curve_formulas_match_host(packed, case):
    """The plain formulas (counterparts of msm_mxu's madd_in, jac_add_in
    and jac_double_in) against the host curve, complete on
    P == Q and P == -Q."""
    ps = list(PackedPowers(packed[:4]))
    qs = {"distinct": list(PackedPowers(packed[4:8])), "equal": ps,
          "opposite": [p.neg() for p in ps]}[case]
    zs = rand_scalars(5, 8)
    pj, qj = _jacobian(ps, zs[:4]), _jacobian(qs, zs[4:])
    ones = [1] * 4
    want = [p.add(q) for p, q in zip(ps, qs)]
    assert _affine(curve.jac_add(pj, qj)) == want
    qa = _jacobian(qs, ones)
    assert _affine(curve.affine_add(_jacobian(ps, ones), qa)) == want
    assert _affine(curve.jac_double(pj)) == [p.double() for p in ps]


def test_curve_formulas_with_infinity(packed):
    pts = list(PackedPowers(packed[:2]))
    inf = g1_infinity()
    ps, qs = [inf, pts[0], inf], [pts[1], inf, inf]
    pj, qj = _jacobian(ps, [3, 5, 7]), _jacobian(qs, [11, 13, 17])
    assert _affine(curve.jac_add(pj, qj)) == [pts[1], pts[0], inf]
    assert _affine(curve.jac_double(pj)) == [inf, pts[0].double(), inf]


def test_pack_points_layout_matches_checkpoint():
    g = g1_generator()
    pts = [g, g.double(), g.mul_scalar(99)]
    assert list(PackedPowers(pack_points(pts))) == pts
