"""Kernels against their plain versions on the card (cuda marker; skipped
where no CUDA device is present). chip_smoke.py is the binding check on the
card; these are the same comparisons at pytest size."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _elements(f, n, seed, dev):
    limbs = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, f.L),
                                                 dtype=np.uint64)
    limbs[:, -1] %= f.modulus >> (32 * (f.L - 1))
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_k1_matches_plain(cuda, which):
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import (
        fq_ops,
        fr_ops,
    )

    f = fr_ops() if which == "fr" else fq_ops()
    a, b = _elements(f, 4096, 1, cuda), _elements(f, 4096, 2, cuda)
    for kern, plain in ((f.mul, f.plain_mul), (f.add, f.plain_add),
                        (f.sub, f.plain_sub)):
        assert torch.equal(kern(a, b), plain(a, b))
        assert torch.equal(kern(a, b[:1]), plain(a, b[:1]))


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_k1_batch_inv_and_pow_match_plain(cuda, which):
    """batch_inv (three launches) and inv (one) at 2^12 rows, with zeros at
    the first and last row, at a chunk boundary and over a whole chunk."""
    from aes_zero_knowledge_proof_circuit_tpu_torch import kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import (
        INV_CHUNK,
        fq_ops,
        fr_ops,
    )

    f = fr_ops() if which == "fr" else fq_ops()
    a = _elements(f, 1 << 12, 4, cuda)
    for i in (0, INV_CHUNK - 1, INV_CHUNK, (1 << 12) - 1):
        a[i] = 0
    a[3 * INV_CHUNK: 4 * INV_CHUNK] = 0
    kernels.reset_counts()
    got = f.batch_inv(a)
    assert kernels.launch_counts()["fr_ops"] <= 3
    assert torch.equal(got, f.plain_batch_inv(a))
    kernels.reset_counts()
    got = f.inv(a[:1000])
    assert kernels.launch_counts()["fr_ops"] == 1
    assert torch.equal(got, f.plain_pow(a[:1000], f.modulus - 2))
    assert torch.equal(f.pow(a, 5), f.plain_pow(a, 5))
    assert torch.equal(f.mul(a[1:], a[:-1]), f.plain_mul(a[1:], a[:-1]))


def test_k2_matches_plain(cuda):
    from aes_zero_knowledge_proof_circuit_tpu_torch import kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine

    eng = ntt_engine(12, cuda)
    x = _elements(fr_ops(), 1 << 12, 3, cuda)
    kernels.reset_counts()
    y = eng.ntt(x)
    assert kernels.launch_counts()["ntt"] <= 2
    assert torch.equal(y, eng.ntt_plain(x))
    assert torch.equal(eng.intt(eng.ntt(x)), x)


@pytest.mark.parametrize("log_n,batch", [(1, 3), (10, 256), (11, 7),
                                         (13, 64)])
def test_k2_batched_matches_plain(cuda, log_n, batch):
    """ntt_rows / intt_rows over [batch, 2^log_n, 8] (the four-step NTT's
    shard shapes) in the launches of one transform, equal to the plain
    passes over the batch and to the transform of each row."""
    from aes_zero_knowledge_proof_circuit_tpu_torch import kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine

    eng = ntt_engine(log_n, cuda)
    x = _elements(fr_ops(), batch << log_n, 6, cuda).view(batch, 1 << log_n,
                                                          8)
    kernels.reset_counts()
    y = eng.ntt_rows(x)
    assert kernels.launch_counts()["ntt"] == len(eng.widths)
    assert torch.equal(y, eng.ntt_rows_plain(x))
    assert torch.equal(eng.intt_rows(x), eng.intt_rows_plain(x))
    for b in (0, batch - 1):
        assert torch.equal(y[b], eng.ntt(x[b]))


def test_mesh_prove_on_one_card(cuda, tmp_path, monkeypatch):
    """dryrun_multichip(4) with the four shards on this card: the sharded
    NTT and MSMs (K1, K2, K3, K4) against the host, the data-parallel fill,
    and a toy-circuit mesh proof equal to the single-device one."""
    from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )

    monkeypatch.setattr(api.CONFIG, "cache_dir", str(tmp_path))
    lines = []
    kernels.reset_counts()
    dryrun_multichip(4, "cuda", say=lines.append)
    counts = kernels.launch_counts()
    assert all(counts[k] for k in ("fr_ops", "ntt", "msm", "msm_u8"))
    assert "equals the single-device one" in lines[-1]


@pytest.mark.parametrize("log_n", [1, 10, 11, 12, 13, 21])
def test_k2_passes_match_plain(cuda, log_n):
    """Forward and inverse (1/n folded into the last pass) on each side of
    the one-pass/two-pass boundary, and at 2^21 in three passes (the
    32-byte key's round-3 cosets)."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine

    eng = ntt_engine(log_n, cuda)
    x = _elements(fr_ops(), 1 << log_n, 10 + log_n, cuda)
    assert torch.equal(eng.ntt(x), eng.ntt_plain(x))
    assert torch.equal(eng.intt(x), eng.intt_plain(x))
    assert torch.equal(eng.intt(eng.ntt(x)), x)


def test_k3_matches_native(cuda):
    """K3 at 2^16 points (13-bit windows: the full reduction geometry)
    against the native Pippenger, and its point and window sums against
    the plain version at 1024 points, with repeated and negated pairs."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native((1 << 16) - 1, random.Random(4))
    packed = srs.powers_g1.packed
    pts = M.points_from_packed(packed, cuda)
    rnd = random.Random(5)
    sc = [rnd.randrange(R_MOD) for _ in range(1 << 16)]
    scalars = fr_ops().from_ints(sc, cuda, mont=False)
    assert M.msm(pts, scalars) == M.native_msm(packed, scalars)
    small = pts[:1024].clone()
    small[1] = small[0]
    sc = sc[:1024]
    sc[1], sc[2] = sc[0], R_MOD - sc[3]
    small[2] = small[3]
    scalars = fr_ops().from_ints(sc, cuda, mont=False)
    for c in (6, 13):
        mags, negs = M.signed_digits(scalars, c)
        args = (small, *M.bucket_runs(mags, negs, 1 << (c - 1)),
                mags.shape[0], 1 << (c - 1), c)
        got, want = M.bucket_msm(*args), M.plain_bucket_msm(*args)
        for g, w in zip(got, want):
            assert M.xyzz_to_affine(g) == M.xyzz_to_affine(w)


def test_k4_matches_plain(cuda):
    """K4's point and window sums at a power of two (the default chunk
    geometry and lanes = 64, many adds a thread over every tree level) with
    equal, opposite and infinity points in one bucket, and at n = 1000 with
    a long equal-digit run and scalars below 2^64 (windows 8-31 all zero);
    then the MSM against the native Pippenger."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (
        edge_inputs as EI,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native(1023, random.Random(4))
    pts = M.points_from_packed(srs.powers_g1.packed, cuda)
    rnd = random.Random(6)
    kinds = {}
    for n, bound, lanes in ((1024, R_MOD, None), (1024, R_MOD, 64),
                            (1000, 1 << 64, None)):
        sc = [rnd.randrange(bound) for _ in range(n)]
        sc[0] = 0
        for i in range(1, 300):
            sc[i] = (sc[i] & ~0xFF) | 0x5A
        edge = EI.k4_edge_points(pts, n)
        plan = MP.land(MD.digit_limbs(fr_ops().from_ints(sc, cuda,
                                                         mont=False)), lanes)
        got = MP.scan_msm(edge, plan)
        want = MP.plain_scan_msm(edge, plan, kinds)
        for g, w in zip(got, want):
            assert M.xyzz_to_affine(g) == M.xyzz_to_affine(w)
    assert all(kinds[k] > 0 for k in MP.KINDS)
    scalars = fr_ops().from_ints(sc, cuda, mont=False)
    assert MD.msm_device(pts, MD.digit_limbs(scalars)) == M.native_msm(
        srs.powers_g1.packed, scalars)


def test_k5_matches_plain(cuda):
    """K5 against its plain version and host integers on random values, on
    band-edge columns (digits up to 318, 0, 1, q - 1 and a value above q,
    as edge_inputs.fq_columns makes them), and at a column count that is not
    a multiple of four (ntt_mul pads it with zero columns)."""
    import random

    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (
        edge_inputs as EI,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import Q_MOD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_ntt_mul as NM

    r = random.Random(8)
    va = [0, 1, Q_MOD - 1] + [r.randrange(Q_MOD) for _ in range(4093)]
    vb = [r.randrange(Q_MOD) for _ in range(4096)]
    a = torch.from_numpy(NM.ints_to_cols(va)).to(cuda)
    b = torch.from_numpy(NM.ints_to_cols(vb)).to(cuda)
    gen = np.random.default_rng(9)
    edge_a = torch.from_numpy(EI.fq_columns(4096, gen)).to(cuda)
    edge_b = torch.from_numpy(np.ascontiguousarray(
        EI.fq_columns(4096, gen)[:, ::-1])).to(cuda)
    for x, y in ((a, b), (edge_a, edge_b), (edge_a, a),
                 (edge_a[:, :4093], edge_b[:, 3:])):
        got = NM.ntt_mul(x, y)
        assert torch.equal(got, NM.plain_ntt_mul(x, y))
        assert NM.cols_to_ints(got) == [
            u * v % Q_MOD for u, v in zip(NM.cols_to_ints(x),
                                          NM.cols_to_ints(y))]


def test_evaluate_batch_on_the_card_matches_the_cpu(cuda):
    """The batched witness fill of the 16-byte CBC template on the card
    equals the same fill on the CPU, and each row the host plan's."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.models.aes_circuit import (
        build_template,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
        WitnessEvaluator,
    )

    tpl = build_template(16, mode="cbc")
    gen = np.random.default_rng(12)
    inputs = {k: gen.integers(0, 2, size=(3, 128), dtype=np.int32)
              for k in ("message", "key", "iv")}
    got = WitnessEvaluator(tpl.plan, cuda).evaluate_batch(inputs)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = WitnessEvaluator(tpl.plan, "cpu").evaluate_batch(inputs)
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(
        want[1].numpy(), tpl.plan.evaluate({k: v[1] for k, v in
                                            inputs.items()}))


def test_plonk_chain_proof_on_the_card_matches_the_cpu(cuda):
    """A Plonk proof of a 2^10-gate chain (n = 2^11, cosets of 2^13) on the
    card, launching K1, K2 and K3, equals the same proof through the plain
    versions on the CPU, field for field, and verifies."""
    import random

    from aes_zero_knowledge_proof_circuit_tpu_torch import kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
        PlonkCircuit,
        setup,
        verify,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
        TorchPlonkProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    from torch_threads import chain_circuit

    c, assign, out = chain_circuit(PlonkCircuit, 1 << 10, R_MOD)
    pk = setup(c, srs=generate_srs_native(c.compile().n + 8,
                                          random.Random(3)))
    kernels.reset_counts()
    got = TorchPlonkProver(pk, cuda).prove(assign, [out], c,
                                           rng=random.Random(6))
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("fr_ops", "ntt", "msm")), counts
    want = TorchPlonkProver(pk, "cpu").prove(assign, [out], c,
                                             rng=random.Random(6))
    assert got == want
    assert verify(pk.vk, got, [out])


def test_k6_matches_plain(cuda):
    """K6 at 2^10 powers of a random tau (with the scalars 0 and 1 among
    them) against its plain version: the same limbs after the same
    normalization, and the normalized points equal s G on the host."""
    import random

    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import fixed_base as FB
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import poly as P
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.curve_host import (
        g1_generator,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        PackedPowers,
    )

    f = fr_ops()
    tau = random.Random(7).randrange(1, R_MOD)
    table = FB.window_table(g1_generator(), cuda)
    sc = f.to_canonical_limbs(P.powers(P.scalar(tau, cuda), 1 << 10))
    sc[5] = 0
    got = FB.to_packed(FB.fixed_base(table, sc))
    assert torch.equal(got, FB.to_packed(FB.plain_fixed_base(table, sc)))
    pts = PackedPowers(got.cpu().numpy().view(np.uint32))
    g = g1_generator()
    for i in (0, 1, 5, 1023):
        assert pts[i] == g.mul_scalar(f.to_ints(sc[i:i + 1], mont=False)[0])


@pytest.mark.parametrize("engine", ["k3", "k4"])
def test_grouped_msm_matches_one_group(cuda, engine, monkeypatch):
    """K3 (msm_point) and K4 (msm_device_point) at 2^16 points with the
    window budget cut to 1, 3 and 7 windows a group: each equals the
    one-group MSM and the native Pippenger."""
    import random

    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )

    n = 1 << 16
    packed = generate_srs_native(n - 1, random.Random(4)).powers_g1.packed
    pts = M.points_from_packed(packed, cuda)
    rnd = random.Random(8)
    scalars = fr_ops().from_ints([rnd.randrange(R_MOD) for _ in range(n)],
                                 cuda, mont=False)
    if engine == "k3":
        run, pair = (lambda: M.msm_point(pts, scalars)), M.PAIR_BYTES
    else:
        run = lambda: MD.msm_device_point(pts, MD.digit_limbs(scalars))
        pair = MP.PAIR_BYTES
    want = M.native_msm(packed, scalars)
    assert M.xyzz_to_affine(run())[0] == want
    for group in (1, 3, 7):
        monkeypatch.setattr(M, "GROUP_BYTES", group * n * pair)
        assert M.xyzz_to_affine(run())[0] == want


def _clear_table_caches():
    """Drop every cached device table of the prove path, as on a cold key."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import ntt, poly
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops

    ntt._engine.cache_clear()
    ntt._bitrev.cache_clear()
    poly._coset_powers.cache_clear()
    fr_ops()._consts.clear()


def test_cached_tables_are_finished_for_a_second_stream(cuda):
    """Cold caches: one thread builds the NTT tables, the bit reversal, the
    coset powers and F.const rows on a stream held up by a device sleep;
    the other then reads them from the caches on its own stream. Both
    workers' first reads equal the tables built alone."""
    import threading

    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import ntt, poly
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        fr_multiplicative_generator,
    )

    f, log_n, g = fr_ops(), 16, fr_multiplicative_generator()

    def tables():
        eng = ntt.ntt_engine(log_n, cuda)
        return [eng.fwd_table, eng.inv_table, eng.n_inv,
                ntt._bitrev(log_n, str(cuda)),
                poly._coset_powers(log_n, g, False, str(cuda)),
                poly._coset_powers(log_n, g, True, str(cuda)),
                f.const("one", cuda), f.const("r2", cuda),
                f.const("r3", cuda), f.const("one_raw", cuda)]

    _clear_table_caches()
    kept = tables()                # held, so no later build reuses them
    alone = [t.clone() for t in kept]
    torch.cuda.synchronize(cuda)
    _clear_table_caches()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    built = threading.Event()
    reads = [None, None]

    def worker(i):
        with torch.cuda.device(cuda), torch.cuda.stream(streams[i]):
            if i == 0:
                torch.cuda._sleep(200_000_000)   # about 0.1 s of the card
                first = tables()
                built.set()
            else:
                assert built.wait(60)
                first = tables()
            reads[i] = [t.clone() for t in first]
        streams[i].synchronize()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for got in reads:
        assert got is not None
        for a, b in zip(got, alone):
            assert torch.equal(a, b)
    del kept


def test_pipelined_proves_on_a_cold_card_equal_proofs_in_turn(cuda):
    """The batch pipeline (`api._prove_pipelined`: two threads, one stream
    each, on one prover) proves four witnesses of a toy circuit on a cold
    key (its first proves build the cached tables); every proof equals,
    byte for byte, the one encrypt's path makes in turn from its seed, and
    a warm batch launches four times one prove's kernels."""
    import random
    import types

    from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
        TorchProver,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import (
        R_MOD,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.dryrun import (
        _toy_circuit,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.serialize import (
        serialize_proof,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )

    cs = _toy_circuit()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    pk = indexer.index(cs, generate_srs_native(need, random.Random(6)), cuda)
    _clear_table_caches()
    prover = TorchProver(pk, cuda)
    key = api.AESProvingKey(marlin_pk=pk, template=None, device=cuda)
    tpl = types.SimpleNamespace(r1cs=cs)
    zs = [torch.tensor([1, pow(x, 9, R_MOD), x, x ** 2, x ** 4, x ** 8],
                       dtype=torch.int32, device=cuda) for x in (2, 3, 5, 7)]
    seeds = [50, 51, 52, 53]
    cold = api._prove_pipelined(key, prover, tpl, zs, seeds, zk=True)
    alone = [api._prove_z(prover, tpl, z, random.Random(s), True)
             for z, s in zip(zs, seeds)]
    kernels.reset_counts()
    warm = api._prove_pipelined(key, prover, tpl, zs, seeds, zk=True)
    counts = kernels.launch_counts()
    kernels.reset_counts()
    api._prove_z(prover, tpl, zs[0], random.Random(seeds[0]), True)
    one = kernels.launch_counts()
    assert counts == {k: 4 * v for k, v in one.items()}
    for a, b, c in zip(cold, warm, alone):
        assert serialize_proof(a) == serialize_proof(c)
        assert serialize_proof(b) == serialize_proof(c)
