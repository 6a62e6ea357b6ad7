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
