"""Port MSM (plain K3 version) vs the host Pippenger of the JAX package and
the native one, and K3's reduction (slices, offset multiples, sum trees, window
ladder) on its own against direct sums.

Points come from the native fixed-base generator (SRS-like, random scalars
from numpy seeds); equality is of affine points as integers, zero
tolerance."""

import numpy as np
import pytest
import torch

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


def xy(p):
    """An affine point of either package as plain integers."""
    return None if p.inf else (int(p.x), int(p.y))


def host_points(packed):
    """The JAX package's points for a packed array."""
    return [g1_infinity() if p.inf else g1_point(p.x, p.y)
            for p in PackedPowers(packed)]


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


def check_msm(pk, sc):
    """The port's MSM against the host Pippenger and the native one."""
    got = M.msm(M.points_from_packed(pk, "cpu"),
                F.from_ints(sc, "cpu", mont=False))
    assert xy(got) == xy(msm_host.msm(host_points(pk), sc))
    assert xy(got) == xy(native().g1_msm_packed(pk, native().pack_scalars(sc)))
    return got


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
    check_msm(pk, sc)


@pytest.mark.parametrize("n", [1, 2, 3, 32, 128, 512])
def test_msm_sizes_from_one_point(packed, n):
    """1 point and 2^1..2^9 points (the narrow windows of small MSMs)."""
    check_msm(packed[:n].copy(), rand_scalars(100 + n, n))


def test_msm_all_zero_and_infinity_points(packed):
    pk = packed[:16].copy()
    pk[4] = 0                                   # the point at infinity
    pts = M.points_from_packed(pk, "cpu")
    zero = F.from_ints([0] * 16, "cpu", mont=False)
    assert M.msm(pts, zero).inf
    sc = rand_scalars(2, 16)
    got = M.msm(pts, F.from_ints(sc, "cpu", mont=False))
    assert xy(got) == xy(msm_host.msm(host_points(pk), sc))


def test_msm_all_scalars_in_one_bucket(packed):
    """300 equal small scalars: one bucket of window 0 holds every point
    (more than SEGMENT pairs), every other bucket is empty."""
    n = 300
    check_msm(packed[:n].copy(), [5] * n)


def test_msm_repeated_and_negated_points(packed):
    """Each point also enters negated (r - s), and as a repeat: P + P and
    P + (-P) meet inside buckets of every window."""
    base = packed[:40]
    pk = np.concatenate([base, base, base])
    sc = rand_scalars(7, 40)
    sc = sc + [R_MOD - s for s in sc] + sc
    got = check_msm(pk, sc)
    assert xy(got) == xy(msm_host.msm(host_points(base),
                                      [s % R_MOD for s in sc[:40]]))


@pytest.mark.parametrize("budget", [1, 700, 1 << 30])
def test_plain_bucket_sums_in_window_groups(packed, budget, monkeypatch):
    """The plain version sums the buckets of a group of windows at a time
    (about PLAIN_PAIRS pairs): one window a group, a few, or all at once
    give the same bucket totals and the same MSM."""
    n, c = 300, 5
    sc = rand_scalars(31, n)
    mags, negs = M.signed_digits(F.from_ints(sc, "cpu", mont=False), c)
    args = (M.points_from_packed(packed[:n], "cpu"),
            *M.bucket_runs(mags, negs, 1 << (c - 1)), mags.shape[0],
            1 << (c - 1))
    whole = M.plain_bucket_sums(*args)
    monkeypatch.setattr(M, "PLAIN_PAIRS", budget)
    got = M.plain_bucket_sums(*args)
    assert got[0].shape == whole[0].shape == (args[4] * args[5], 12)
    affine = lambda t: [xy(p) for p in M.xyzz_to_affine(M.jac_to_xyzz(t))]
    assert affine(got) == affine(whole)
    point, _ = M.plain_bucket_msm(*args, c)
    assert xy(M.xyzz_to_affine(point)[0]) == xy(
        msm_host.msm(host_points(packed[:n]), sc))


@pytest.mark.parametrize("c", [2, 5, 13])
def test_window_width_below_13_and_full(packed, c):
    """bucket_msm at an explicit window width on 100 points (the widths
    that small MSMs take, and the full 13-bit, 20-window geometry whose
    reduction runs 32 blocks of 64 two-bucket slices a window)."""
    n = 100
    pk = packed[:n]
    sc = rand_scalars(200 + c, n)
    scalars = F.from_ints(sc, "cpu", mont=False)
    mags, negs = M.signed_digits(scalars, c)
    idx, neg, offsets = M.bucket_runs(mags, negs, 1 << (c - 1))
    point, wsums = M.bucket_msm(M.points_from_packed(pk, "cpu"), idx, neg,
                                offsets, mags.shape[0], 1 << (c - 1), c)
    want = msm_host.msm(host_points(pk), sc)
    assert xy(M.xyzz_to_affine(point)[0]) == xy(want)
    # the window sums, as the host ladder of msm_host combines them
    acc = g1_infinity()
    for p in reversed(M.xyzz_to_affine(wsums)):
        for _ in range(c):
            acc = acc.double()
        acc = acc.add(g1_point(p.x, p.y) if not p.inf else g1_infinity())
    assert xy(acc) == xy(want)


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


@pytest.mark.parametrize("n", [1, 300, 1000])
def test_segments_cut_each_bucket_run(n):
    """K3's segments: each bucket's run (bucket 0 skipped) cut into pieces
    of at most SEGMENT pairs in order; the room past the last is empty."""
    c = 4
    b = 1 << (c - 1)
    sc = [3] * (n // 2) + rand_scalars(5, n - n // 2)
    mags, negs = M.signed_digits(F.from_ints(sc, "cpu", mont=False), c)
    _idx, _neg, offsets = M.bucket_runs(mags, negs, b)
    w = mags.shape[0]
    lo, hi, owner, first = M._segments(offsets, w, b, w * n)
    assert lo.shape[0] == -(-w * n // M.SEGMENT) + w * b
    for t in range(w * b):
        start = int(offsets[(t // b) * (b + 1) + t % b + 1])
        end = int(offsets[(t // b) * (b + 1) + t % b + 2])
        segs = range(int(first[t]), int(first[t + 1]))
        assert [(int(lo[s]), int(hi[s])) for s in segs] == [
            (a, min(a + M.SEGMENT, end))
            for a in range(start, end, M.SEGMENT)]
        assert all(int(owner[s]) == t for s in segs)
    assert bool((lo[int(first[-1]):] == hi[int(first[-1]):]).all())


@pytest.mark.parametrize("sizes", [[0, 1, 2, 3, 0, 5, 8, 0], [512, 1, 0, 7],
                                   [1] * 9, [0, 0]])
def test_merge_plan_joins_every_bucket(sizes):
    """The merge kernel's indexing, run here on integers: thread u of level
    p finds its bucket in merge_plan's row p and adds partial s + 2^p into
    partial s; afterwards each bucket's first partial is its total, every
    join stays inside its bucket, and no level needs more threads than the
    launch gives it (n_partial / 2^p)."""
    first = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int64)
    n = int(first[-1])
    passes = M.merge_passes(max(sizes))
    prefix = M.merge_plan(first, passes)
    vals = [3 ** i for i in range(n)]
    for p in range(passes):
        row = prefix[p].tolist()
        assert row[-1] <= -(-n // (1 << p))
        for u in range(row[-1]):
            t = max(i for i in range(len(sizes)) if row[i] <= u)
            s = int(first[t]) + (u - row[t]) * 2 ** (p + 1)
            assert s + 2 ** p < int(first[t + 1])
            vals[s] += vals[s + 2 ** p]
    for t, m in enumerate(sizes):
        lo = int(first[t])
        if m:
            assert vals[lo] == sum(3 ** i for i in range(lo, lo + m))


@pytest.mark.parametrize("buckets,windows,fill", [
    (2, 3, 1.0), (8, 2, 1.0), (128, 2, 1.0), (4096, 1, 0.02)])
def test_reduction_tree_alone(packed, buckets, windows, fill):
    """plain_window_sums, the kernel's reduction step for step: bucket sums
    in (Jacobian, random z, some empty, some equal or opposite to a
    neighbour), sum_b b B_b per window out, against a direct host sum."""
    rng = np.random.default_rng(buckets)
    host = host_points(np.resize(packed, (windows * buckets, 2, 24)))
    pts = []
    for i, p in enumerate(host):
        if rng.random() >= fill:
            p = g1_infinity()
        elif i % 7 == 3 and i:
            p = pts[-1]                         # equal to the neighbour
        elif i % 7 == 5 and i:
            p = pts[-1].neg()                   # opposite
        pts.append(p)
    zs = [int(v) for v in rng.integers(1, 1 << 62, size=len(pts))]
    rows = [(0, 0, 0) if p.inf else
            (p.x * z * z % Q_MOD, p.y * z ** 3 % Q_MOD, z)
            for p, z in zip(pts, zs)]
    bsum = tuple(fq_ops().from_ints([r[i] for r in rows], "cpu")
                 for i in range(3))
    got = M.xyzz_to_affine(M.jac_to_xyzz(
        M.plain_window_sums(bsum, windows, buckets)))
    for w in range(windows):
        seg = pts[w * buckets:(w + 1) * buckets]
        want = msm_host.msm(seg, list(range(1, buckets + 1)))
        assert xy(got[w]) == xy(want)


def test_offset_multiples_alone(packed):
    """add_multiple (step 2 of the reduction): acc + k run per row for k of
    every bit length up to 12, k = 0, and run or acc at infinity or equal
    or opposite to the multiple."""
    host = host_points(packed[:12])
    ks = [0, 1, 2, 3, 5, 64, 127, 1000, 4094, 4095, 7, 2]
    runs = list(host)
    accs = list(reversed(host))
    runs[8], accs[9] = g1_infinity(), g1_infinity()
    accs[10] = runs[10].mul_scalar(7).neg()                    # acc + k run = inf
    accs[11] = runs[11].mul_scalar(2)                          # acc == k run
    got = _affine(M.add_multiple(_jacobian(accs, [3] * 12),
                                 _jacobian(runs, [5] * 12),
                                 torch.tensor(ks, dtype=torch.int64)))
    for g, a, r, k in zip(got, accs, runs, ks):
        want = a.add(r.mul_scalar(k))
        assert g == (None if want.inf else (want.x, want.y))


def test_reduce_geometry_fills_the_first_step():
    assert M.reduce_geometry(4096) == (2, 6)     # 20 x 4096: 320 blocks
    assert M.reduce_geometry(1024) == (2, 6)
    assert M.reduce_geometry(256) == (1, 6)      # K4: 2 blocks a window
    assert M.reduce_geometry(64) == (0, 6)
    assert M.reduce_geometry(2) == (0, 1)


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
            out.append(None)
        else:
            zi = pow(z, -1, Q_MOD)
            out.append((x * zi * zi % Q_MOD, y * zi ** 3 % Q_MOD))
    return out


@pytest.mark.parametrize("case", ["distinct", "equal", "opposite"])
def test_curve_formulas_match_host(packed, case):
    """The plain formulas (counterparts of msm_mxu's madd_in, jac_add_in
    and jac_double_in) against the host curve, complete on
    P == Q and P == -Q."""
    ps = host_points(packed[:4])
    qs = {"distinct": host_points(packed[4:8]), "equal": ps,
          "opposite": [p.neg() for p in ps]}[case]
    zs = rand_scalars(5, 8)
    pj, qj = _jacobian(ps, zs[:4]), _jacobian(qs, zs[4:])
    ones = [1] * 4
    want = [xy(p.add(q)) for p, q in zip(ps, qs)]
    assert _affine(curve.jac_add(pj, qj)) == want
    qa = _jacobian(qs, ones)
    assert _affine(curve.affine_add(_jacobian(ps, ones), qa)) == want
    assert _affine(curve.jac_double(pj)) == [xy(p.double()) for p in ps]


def test_curve_formulas_with_infinity(packed):
    pts = host_points(packed[:2])
    inf = g1_infinity()
    ps, qs = [inf, pts[0], inf], [pts[1], inf, inf]
    pj, qj = _jacobian(ps, [3, 5, 7]), _jacobian(qs, [11, 13, 17])
    assert _affine(curve.jac_add(pj, qj)) == [xy(pts[1]), xy(pts[0]), None]
    assert _affine(curve.jac_double(pj)) == [None, xy(pts[0].double()), None]


def test_xyzz_round_trip():
    pts = host_points(pack_points([g1_generator().mul_scalar(k)
                                   for k in (1, 2, 99)]))
    jac = _jacobian(pts + [g1_infinity()], [5, 7, 11, 13])
    got = M.xyzz_to_affine(M.jac_to_xyzz(jac))
    assert [xy(p) for p in got] == [xy(p) for p in pts] + [None]
    back = M.affine_to_xyzz(got[2], "cpu")
    assert xy(M.xyzz_to_affine(back)[0]) == xy(pts[2])
    assert M.xyzz_to_affine(torch.zeros((4, 12), dtype=torch.int32))[0].inf


def test_pack_points_layout_matches_checkpoint():
    g = g1_generator()
    pts = [g, g.double(), g.mul_scalar(99)]
    assert [xy(p) for p in PackedPowers(pack_points(pts))] == [
        xy(p) for p in pts]


def test_host_msm_over_a_packed_slice(packed):
    """The host MSM over a slice of packed SRS powers (a packed view, the
    native MSM on the checkpoint layout) equals it over the same points as
    a list, and the Python Pippenger."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (
        msm_host as port_msm_host,
    )

    powers = PackedPowers(packed)
    view = powers[3:300]
    assert isinstance(view, PackedPowers)
    assert [xy(p) for p in view] == [xy(powers[i]) for i in range(3, 300)]
    sc = rand_scalars(31, len(view))
    got = port_msm_host.msm(view, sc)
    assert xy(got) == xy(port_msm_host.msm(list(view), sc))
    assert xy(got) == xy(port_msm_host._msm_python(list(view), sc))
