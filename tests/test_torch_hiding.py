"""The KZG hiding terms of the port's prover (`ops/kzg.hiding_terms`): each
equals msm_host's Python Pippenger over the SRS's gamma powers point for
point, through the native library and through the Python fallback when
the library is unavailable, and the counters say which ran."""

import random

import pytest

from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg, msm_host
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import native, spans


@pytest.fixture(scope="module")
def bases():
    srs = kzg.setup(1, random.Random(31))
    return kzg.HidingBases(srs.gamma_powers_g1)


def randoms(rng, n):
    return [rng.randrange(R_MOD) for _ in range(n)]


CASES = {
    "two_terms": lambda rng: [randoms(rng, 2) for _ in range(4)],
    "eight_terms": lambda rng: [randoms(rng, 8), randoms(rng, 8)],
    "zero_scalar": lambda rng: [[0, rng.randrange(R_MOD)],
                                randoms(rng, 3) + [0] + randoms(rng, 4)],
    "all_zero": lambda rng: [[0, 0], [0] * 8],
    "at_least_r": lambda rng: [[R_MOD, R_MOD + 1],
                               [2 * R_MOD - 1, 1 << 300] + randoms(rng, 6)],
    "python_fallback": lambda rng: [randoms(rng, 2), randoms(rng, 8)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_hiding_terms_equal_the_python_pippenger(bases, case, monkeypatch):
    polys = CASES[case](random.Random(case))
    fallback = case == "python_fallback"
    if fallback:
        monkeypatch.setattr(native, "lib", lambda: None)
    else:
        assert native.available()
    spans.enable()
    try:
        got = kzg.hiding_terms(bases, polys)
    finally:
        spans.disable()
    _spans, counters = spans.drain()
    want = [msm_host._msm_python(bases.points[:len(r)],
                                 [c % R_MOD for c in r]) for r in polys]
    assert got == want
    assert all(p.is_on_curve() for p in got)
    if case == "all_zero":
        assert all(p.inf for p in got)
    else:
        assert not any(p.inf for p in got)
    assert counters == {"hiding_terms": 0 if fallback else len(polys),
                        "hiding_terms_python": len(polys) if fallback else 0}
