"""What a 1 KB message needs of the port, at small sizes on the CPU (plain
kernel versions); no test builds the 1 KB template, which takes minutes.

* K3 and K4 in groups of windows (`msm.window_groups`, forced small through
  the module budget GROUP_BYTES) equal the one-group MSM and the JAX
  package's host Pippenger;
* the group planner covers every window once, keeps a group within the
  budget at the 1 KB sizes (K3 at 2^26, K4 at 2^25) and is one group up to
  2^22 points;
* whole zk=False proofs with the groups forced small equal the host
  prover's on both MSM engines;
* the device SRS (`utils/srs.generate_srs_device`, here the plain K6)
  equals the port's native SRS, the JAX package's native SRS and the JAX
  package's device ladder;
* the template's constraint-system status counts only the rows added since
  its last call and still equals the JAX package's.

Equality is of affine points as integers and proofs as serialized bytes:
zero tolerance."""

import random

import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import msm_host
from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    g1_generator,
    g1_infinity,
    g1_point,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.native import native
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import PackedPowers
from tests.torch_threads import jax_srs, one_torch_thread  # noqa: F401

F = fr_ops()
N = 1 << 10


def xy(p):
    return None if p.inf else (int(p.x), int(p.y))


def g2xy(p):
    """A G2 point of either package as plain integers."""
    return (p.x.c0, p.x.c1, p.y.c0, p.y.c1)


def rand_scalars(seed: int, n: int):
    raw = np.random.default_rng(seed).bytes(n * 40)
    return [int.from_bytes(raw[40 * i: 40 * i + 40], "little") % R_MOD
            for i in range(n)]


@pytest.fixture(scope="module")
def case():
    """2^10 SRS-like points (native fixed-base generator), packed and as
    the JAX package's host points, and 2^10 scalars with a zero."""
    packed = native().g1_powers_fixed_base_packed(g1_generator(),
                                                  rand_scalars(1, N))
    assert packed is not None, "native zkhost library unavailable"
    host = [g1_infinity() if p.inf else g1_point(p.x, p.y)
            for p in PackedPowers(packed)]
    sc = rand_scalars(2, N)
    sc[5] = 0
    want = msm_host.msm(host, sc)
    return M.points_from_packed(packed, "cpu"), sc, want


def spy(monkeypatch, module, name):
    """Record the `ladder` argument of every call of module.name."""
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(kwargs.get("ladder", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("group", [1, 3, 7])
def test_k3_window_groups_equal_one_group(case, group, monkeypatch):
    """msm_point with the budget set to `group` windows of 2^10 pairs: one
    bucket_msm a group, the ladder in the last only; the point equals the
    one-group MSM's and the host Pippenger's."""
    points, sc, want = case
    scalars = F.from_ints(sc, "cpu", mont=False)
    one = M.xyzz_to_affine(M.msm_point(points, scalars))[0]
    monkeypatch.setattr(M, "GROUP_BYTES", group * N * M.PAIR_BYTES)
    calls = spy(monkeypatch, M, "bucket_msm")
    got = M.xyzz_to_affine(M.msm_point(points, scalars))[0]
    windows = M.n_windows(M.window_bits(N))
    assert calls == [False] * (-(-windows // group) - 1) + [True]
    assert xy(got) == xy(one) == xy(want)


@pytest.mark.parametrize("group", [1, 5, 8])
def test_k4_window_groups_equal_one_group(case, group, monkeypatch):
    """msm_device_point with the budget set to `group` windows: one
    scan_msm a group, the window pairs and ladder in the last only; the
    point and the 32 window sums equal the one-group MSM's, and the point
    the host Pippenger's."""
    points, sc, want = case
    digits = MD.digit_limbs(F.from_ints(sc, "cpu", mont=False))
    one_point, one_sums = MP.msm_parts(points, digits)
    monkeypatch.setattr(M, "GROUP_BYTES", group * N * MP.PAIR_BYTES)
    calls = spy(monkeypatch, MP, "scan_msm")
    point, sums = MP.msm_parts(points, digits)
    assert calls == [False] * (-(-MP.WINDOWS // group) - 1) + [True]
    assert xy(M.xyzz_to_affine(point)[0]) == xy(
        M.xyzz_to_affine(one_point)[0]) == xy(want)
    assert [xy(p) for p in M.xyzz_to_affine(sums)] == [
        xy(p) for p in M.xyzz_to_affine(one_sums)]


def k3_windows(n: int) -> int:
    return M.n_windows(M.window_bits(n))


@pytest.mark.parametrize("log_n", range(0, 27))
def test_window_groups_cover_every_window_once(log_n):
    """Both engines' plans at the real budget: consecutive, non-empty
    groups covering every window once."""
    n = 1 << log_n
    for windows, pair in ((k3_windows(n), M.PAIR_BYTES),
                          (MP.WINDOWS, MP.PAIR_BYTES)):
        plan = M.window_groups(windows, n, pair, M.GROUP_BYTES)
        assert all(isinstance(w, int) for g in plan for w in g)
        assert [w for w0, w1 in plan for w in range(w0, w1)] == list(
            range(windows))
        assert all(w1 > w0 for w0, w1 in plan)


def test_window_groups_fit_the_budget_at_1kb_and_one_group_to_2_22():
    """A 1 KB proof commits up to 2^26 points on K3 and its index 2^25 on
    K4: there each group's reckoned bytes stay within GROUP_BYTES (seven
    groups on K3 at 2^26, ten at the 2^26 + 1 points of the whole SRS,
    eight on K4). Up to 2^22 (64 bytes) each engine runs one group, as
    before groups existed."""
    for n, windows, pair in (
            (1 << 26, k3_windows(1 << 26), M.PAIR_BYTES),
            ((1 << 26) + 1, k3_windows((1 << 26) + 1), M.PAIR_BYTES),
            (1 << 25, MP.WINDOWS, MP.PAIR_BYTES)):
        plan = M.window_groups(windows, n, pair, M.GROUP_BYTES)
        assert len(plan) > 1
        assert max(w1 - w0 for w0, w1 in plan) * n * pair <= M.GROUP_BYTES
    assert M.window_groups(20, 1 << 26, M.PAIR_BYTES, M.GROUP_BYTES) == [
        (0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18), (18, 20)]
    assert M.window_groups(20, (1 << 26) + 1, M.PAIR_BYTES,
                           M.GROUP_BYTES) == [(w, w + 2)
                                              for w in range(0, 20, 2)]
    assert len(M.window_groups(MP.WINDOWS, 1 << 25, MP.PAIR_BYTES,
                               M.GROUP_BYTES)) == 8
    for log_n in range(0, 23):
        n = 1 << log_n
        assert M.window_groups(k3_windows(n), n, M.PAIR_BYTES,
                               M.GROUP_BYTES) == [(0, k3_windows(n))]
        assert M.window_groups(MP.WINDOWS, n, MP.PAIR_BYTES,
                               M.GROUP_BYTES) == [(0, MP.WINDOWS)]


@pytest.fixture(scope="module")
def toy():
    from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer
    from tests.test_marlin import build_toy_circuit

    cs, assignment = build_toy_circuit()
    na, nb, nc = cs.nnz()
    srs = indexer.generate_universal_srs(
        cs.num_constraints, cs.num_variables, max(na, nb, nc),
        random.Random(21))
    return cs, assignment, indexer.index(cs, srs)


@pytest.mark.parametrize("engine,budget", [("mxu", 1 << 16),
                                           ("pallas", 1 << 14)])
def test_grouped_prove_equals_host(toy, engine, budget, monkeypatch):
    """A zk=False proof of the toy circuit with the budget cut to `budget`
    bytes, so that its commitments and openings (up to 18 points) run
    several groups of windows on the engine (K3 at 18 points: 56 of its
    128 two-bit windows a group; K4: 11 of 32), equals the host prover's
    byte for byte."""
    from aes_zero_knowledge_proof_circuit_tpu.marlin import prover
    from aes_zero_knowledge_proof_circuit_tpu.utils import serialize as jser
    from aes_zero_knowledge_proof_circuit_tpu_torch import convert
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
        TorchProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize

    _cs, assignment, pk = toy
    inst, wit = assignment(3, 4)
    want = prover.prove(pk, inst, wit, rng=random.Random(1), zk=False)
    monkeypatch.setattr(M, "GROUP_BYTES", budget)
    calls = spy(monkeypatch, M if engine == "mxu" else MP,
                "bucket_msm" if engine == "mxu" else "scan_msm")
    tp = TorchProver(convert.proving_key_from(pk), "cpu", msm_engine=engine)
    got = tp.prove(inst, np.asarray(wit), rng=random.Random(2), zk=False)
    assert serialize.serialize_proof(got) == jser.serialize_proof(want)
    assert calls.count(False) > 0 and calls.count(True) == 19


@pytest.mark.parametrize("seed", [3, 4])
def test_device_srs_equals_native_and_jax(seed, monkeypatch):
    """generate_srs_device at degree 2^8 - 1 (plain K6 on the CPU, chunks
    of 100 powers) equals the port's generate_srs_native and the JAX
    package's native SRS from the same seed: packed powers, gamma powers,
    h and tau_h. Its powers also equal the JAX package's device ladder
    (`fixed_base_msm_device` over `_window_tables`, normalized by
    `jacobian_to_affine_packed`) on the standard-form powers of the same
    tau. The JAX package's own `generate_srs_device` cannot be the
    reference: it hands the ladder the Montgomery form of the powers
    (`to_canonical_limbs` of Montgomery rows), so its first power is R G
    and its own check `powers[0] == g` fails."""
    import jax.numpy as jnp

    from aes_zero_knowledge_proof_circuit_tpu.parallel import srs_gen
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils import srs

    monkeypatch.setattr(srs, "SRS_CHUNK", 100)
    degree = (1 << 8) - 1
    got = srs.generate_srs_device(degree, random.Random(seed), "cpu")
    port = srs.generate_srs_native(degree, random.Random(seed))
    jax_native = jax_srs(degree, seed)
    for other in (port, jax_native):
        assert np.array_equal(got.powers_g1.packed,
                              np.asarray(other.powers_g1.packed))
        assert [xy(p) for p in got.gamma_powers_g1] == [
            xy(p) for p in other.gamma_powers_g1]
        assert [g2xy(p) for p in (got.h, got.tau_h)] == [
            g2xy(p) for p in (other.h, other.tau_h)]
    tau = random.Random(seed).randrange(1, R_MOD)
    powers = [pow(tau, i, R_MOD) for i in range(degree + 1)]
    digits = np.asarray([[(s >> (8 * w)) & 0xFF for w in range(32)]
                         for s in powers], np.int32)
    table = srs_gen._tables_to_device(srs_gen._window_tables(g1_generator()))
    jac = srs_gen.fixed_base_msm_device(table, jnp.asarray(digits))
    assert np.array_equal(got.powers_g1.packed,
                          srs_gen.jacobian_to_affine_packed(jac))


def test_window_table_equals_jax():
    """K6's table T[w][d] = d 2^(8 w) G equals the JAX package's
    `_window_tables` (row d = 0 as infinity)."""
    from aes_zero_knowledge_proof_circuit_tpu.parallel import srs_gen
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import fixed_base
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fq_ops

    table = fixed_base.window_table(g1_generator(), "cpu")
    fq = fq_ops()
    xs = fq.to_ints(table[..., 0, :])
    ys = fq.to_ints(table[..., 1, :])
    want = [p for row in srs_gen._window_tables(g1_generator()) for p in row]
    assert [None if x == y == 0 else (x, y) for x, y in zip(xs, ys)] == [
        xy(p) for p in want]


def test_fixed_base_kernel_wrapper_and_plain_agree_on_the_cpu():
    """On CPU tensors the K6 wrapper is its plain version; the normalized
    points are s G for edge scalars (0, 1, r - 1, a byte in every window)."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import fixed_base

    g = g1_generator()
    sc = [0, 1, R_MOD - 1, int.from_bytes(bytes(range(1, 33)), "little")
          % R_MOD, 255 << 240]
    table = fixed_base.window_table(g, "cpu")
    scalars = F.from_ints(sc, "cpu", mont=False)
    packed = fixed_base.to_packed(fixed_base.fixed_base(table, scalars))
    got = PackedPowers(packed.numpy().view(np.uint32))
    assert [xy(got[i]) for i in range(len(sc))] == [
        xy(g.mul_scalar(s)) for s in sc]


def test_srs_for_generates_saves_and_truncates(tmp_path, monkeypatch):
    """api._srs_for on the CPU: a fresh native SRS, checkpointed; the same
    degree loads it back; a smaller degree truncates it."""
    from aes_zero_knowledge_proof_circuit_tpu_torch import api
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )

    monkeypatch.setattr(api.CONFIG, "cache_dir", str(tmp_path))
    srs = api._srs_for(63, random.Random(9), "cpu")
    want = generate_srs_native(63, random.Random(9))
    assert np.array_equal(srs.powers_g1.packed, want.powers_g1.packed)
    again = api._srs_for(63, random.Random(10), "cpu")
    assert np.array_equal(again.powers_g1.packed, want.powers_g1.packed)
    small = api._srs_for(31, random.Random(11), "cpu")
    assert np.array_equal(small.powers_g1.packed, want.powers_g1.packed[:32])


def test_template_status_counts_rows_incrementally():
    """R1CS.nnz keeps running counts that enforce adds to, so the
    template's per-round status log is linear in the circuit's size; the
    counts equal a recount after enforces and after finalized(), and the
    16-byte template's status log equals the JAX package's."""
    from aes_zero_knowledge_proof_circuit_tpu.models.aes_circuit import (
        build_template as jax_build,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.models.aes_circuit import (
        build_template,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.models.r1cs import R1CS

    cs = R1CS()
    rnd = random.Random(12)
    for i in range(50):
        lc = lambda: {rnd.randrange(-5, 5): 1 for _ in range(rnd.randrange(4))}
        cs.enforce(lc(), lc(), lc())
        if i % 7 == 0:
            assert cs.nnz() == tuple(sum(len(r) for r in rows) for rows in (
                cs.a_rows, cs.b_rows, cs.c_rows))
    fin = cs.finalized()
    assert fin.nnz() == tuple(sum(len(r) for r in rows) for rows in (
        fin.a_rows, fin.b_rows, fin.c_rows))
    assert build_template(16).stage_log == jax_build(16).stage_log


@pytest.mark.parametrize("chunk", [4, 12, 1 << 27])
def test_mask_draw_in_chunks_equals_one_draw(chunk, monkeypatch):
    """The prover's mask draws its bytes in chunks (a 1 KB proof's 2^25 + 1
    elements take 34 (2^25 + 1) bytes, more than one randbytes call can
    give); chunks of whole 32-bit words give the bytes of one call, so the
    elements and the rng's state after the draw are the same."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import prover

    want_rng = random.Random(33)
    raw = np.frombuffer(want_rng.randbytes(37 * prover.RAND_BYTES), np.uint8)
    monkeypatch.setattr(prover, "RAND_CHUNK", chunk)
    rng = random.Random(33)
    got = prover._rand_mont(rng, 37, "cpu")
    assert rng.random() == want_rng.random()
    vals = [int.from_bytes(raw[34 * i: 34 * i + 34].tobytes(), "little")
            % R_MOD for i in range(37)]
    assert F.to_ints(got) == vals


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_exact_sums_in_chunks_equal_one_pass(rows, monkeypatch):
    """tree_sum, prefix_sum (both ways), div_vanishing and segment_sum_mod
    over SUM_ROWS rows at a time (a 1 KB proof's 2^26-row sums would take
    32 GiB in one pass) give the limbs of one pass and the host's sums."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import poly as P

    vals = [int(v) % R_MOD for v in rand_scalars(40, 37)]
    x = F.from_ints(vals, "cpu")
    seg = torch.from_numpy(np.random.default_rng(41).integers(0, 5, 37))

    def run():
        return (P.tree_sum(x), P.prefix_sum(x), P.prefix_sum(x, True),
                *P.div_vanishing(x, 8), P.segment_sum_mod(x, seg, 5))

    whole = run()
    monkeypatch.setattr(P, "SUM_ROWS", rows)
    for got, want in zip(run(), whole):
        assert torch.equal(got, want)
    assert F.to_ints(whole[0]) == [sum(vals) % R_MOD]
    assert F.to_ints(whole[1]) == [sum(vals[:i + 1]) % R_MOD
                                   for i in range(37)]
    assert F.to_ints(whole[2]) == [sum(vals[i:]) % R_MOD for i in range(37)]
