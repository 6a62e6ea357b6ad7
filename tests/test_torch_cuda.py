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


def test_k2_matches_plain(cuda):
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine

    eng = ntt_engine(12, cuda)
    x = _elements(fr_ops(), 1 << 12, 3, cuda)
    assert torch.equal(eng.ntt(x), eng.ntt_plain(x))
    assert torch.equal(eng.intt(eng.ntt(x)), x)


def test_k3_matches_native(cuda):
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native(1023, random.Random(4))
    pts = M.points_from_packed(srs.powers_g1.packed, cuda)
    sc = [random.Random(5).randrange(R_MOD) for _ in range(1024)]
    scalars = fr_ops().from_ints(sc, cuda, mont=False)
    assert M.msm(pts, scalars) == M.native_msm(srs.powers_g1.packed, scalars)


def test_k4_matches_plain(cuda):
    """Window sums of the 8-bit bucket scan, as affine points per window,
    at a power of two and at n = 1000 with a long equal-digit run and
    scalars below 2^64 (windows 8-31 all zero), then the MSM against the
    native Pippenger."""
    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
        generate_srs_native,
    )
    import random

    srs = generate_srs_native(1023, random.Random(4))
    pts = M.points_from_packed(srs.powers_g1.packed, cuda)
    rnd = random.Random(6)
    for n, bound, lanes in ((1024, R_MOD, None), (1024, R_MOD, 64),
                            (1000, 1 << 64, None)):
        sc = [rnd.randrange(bound) for _ in range(n)]
        sc[0] = 0
        for i in range(1, 300):
            sc[i] = (sc[i] & ~0xFF) | 0x5A
        plan = MP.land(MD.digit_limbs(fr_ops().from_ints(sc, cuda,
                                                         mont=False)), lanes)
        got = M.window_points(MP.scan_window_sums(pts[:n], plan))
        assert got == M.window_points(MP.plain_scan_window_sums(pts[:n],
                                                                plan))
    scalars = fr_ops().from_ints(sc, cuda, mont=False)
    assert MD.msm_device(pts, MD.digit_limbs(scalars)) == M.native_msm(
        srs.powers_g1.packed, scalars)


def test_k5_matches_plain(cuda):
    import random

    from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_ntt_mul as NM

    r = random.Random(8)
    va = [0, 1, Q_MOD - 1] + [r.randrange(Q_MOD) for _ in range(4093)]
    vb = [r.randrange(Q_MOD) for _ in range(4096)]
    a = torch.from_numpy(NM.ints_to_cols(va)).to(cuda)
    b = torch.from_numpy(NM.ints_to_cols(vb)).to(cuda)
    got = NM.ntt_mul(a, b)
    assert torch.equal(got, NM.plain_ntt_mul(a, b))
    assert NM.cols_to_ints(got) == [x * y % Q_MOD for x, y in zip(va, vb)]
