"""Port NTT (plain K2 stages) and polynomial toolbox vs the JAX NTTEngine,
the Pallas butterfly in interpret mode, poly_jax and the host domain.

Exact arithmetic: zero tolerance at canonical integers; inputs from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import poly_host, poly_jax
from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
    digits_to_ints,
    fr_f32,
    ints_to_digits,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu.ops.ntt_jax import NTTEngine
from aes_zero_knowledge_proof_circuit_tpu.ops.scan_utils import hillis_scan
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import ntt as N
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import poly as P
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
from tests.torch_threads import one_torch_thread  # noqa: F401

INTERP = jax.default_backend() != "tpu"
F = fr_ops()
G = fr_f32()


def rand_ints(seed: int, n: int):
    raw = np.random.default_rng(seed).bytes(n * 40)
    return [int.from_bytes(raw[40 * i: 40 * i + 40], "little") % R_MOD
            for i in range(n)]


def jdig(vals):
    return jnp.asarray(ints_to_digits(G, vals))


@pytest.mark.parametrize("log_n", list(range(1, 13)))
def test_ntt_matches_host_domain(log_n):
    d = poly_host.domain(log_n)
    vals = rand_ints(log_n, d.n)
    x = P.dpoly(vals, "cpu")
    fwd = P.ntt_to(log_n, x)
    assert F.to_ints(fwd) == d.ntt(vals)
    assert F.to_ints(P.intt(log_n, x)) == d.intt(vals)
    assert F.to_ints(P.intt(log_n, fwd)) == vals


@pytest.mark.parametrize("log_n", [1, 4, 8])
def test_ntt_matches_jax_engine(log_n):
    eng = NTTEngine(log_n)
    vals = rand_ints(100 + log_n, 1 << log_n)
    x = P.dpoly(vals, "cpu")
    assert F.to_ints(P.ntt_to(log_n, x)) == digits_to_ints(
        G, eng.ntt(jdig(vals)))
    assert F.to_ints(P.intt(log_n, x)) == digits_to_ints(
        G, eng.intt(jdig(vals)))


@pytest.mark.parametrize("log_n", list(range(1, 13)))
def test_plain_passes_match_host_and_jax(log_n):
    """The plain K2 passes forced to at most 3 stages a pass (up to four
    passes, bit reversal in the first, 1/n in the last) against the host
    domain and the JAX NTTEngine."""
    eng = N.NTTEngine(log_n, "cpu", pass_log=3)
    assert sum(eng.widths) == log_n and max(eng.widths) <= 3
    d = poly_host.domain(log_n)
    vals = rand_ints(200 + log_n, d.n)
    x = P.dpoly(vals, "cpu")
    fwd = F.to_ints(eng.ntt(x))
    assert fwd == d.ntt(vals)
    assert F.to_ints(eng.intt(x)) == d.intt(vals)
    jeng = NTTEngine(log_n)
    assert fwd == digits_to_ints(G, jeng.ntt(jdig(vals)))
    assert F.to_ints(eng.intt(x)) == digits_to_ints(G, jeng.intt(jdig(vals)))


@pytest.mark.parametrize("log_n", [11, 12])
def test_intt_folded_scale_matches_jax(log_n):
    """Two passes at the default width, 1/n folded into the last one."""
    eng = N.ntt_engine(log_n, "cpu")
    assert eng.widths == N.pass_widths(log_n) and len(eng.widths) == 2
    vals = rand_ints(300 + log_n, 1 << log_n)
    want = digits_to_ints(G, NTTEngine(log_n).intt(jdig(vals)))
    assert F.to_ints(eng.intt(P.dpoly(vals, "cpu"))) == want


@pytest.mark.parametrize("log_n,pass_log,widths", [
    (1, 10, [1]), (10, 10, [10]), (11, 10, [6, 5]), (20, 10, [10, 10]),
    (21, 10, [7, 7, 7]), (7, 3, [3, 2, 2]), (12, 3, [3, 3, 3, 3])])
def test_pass_widths(log_n, pass_log, widths):
    assert N.pass_widths(log_n, pass_log) == widths


def test_ntt_matches_pallas_butterfly_engine():
    """The JAX engine with its fused Pallas butterfly (interpret mode)."""
    log_n = 5
    eng = NTTEngine(log_n, use_pallas=True, interpret=INTERP)
    vals = rand_ints(7, 1 << log_n)
    x = P.dpoly(vals, "cpu")
    assert F.to_ints(P.ntt_to(log_n, x)) == digits_to_ints(
        G, eng.ntt(jdig(vals)))
    assert F.to_ints(P.intt(log_n, x)) == digits_to_ints(
        G, eng.intt(jdig(vals)))


def test_plain_stage_is_one_butterfly_layer():
    """One K2 stage (plain pass of one stage) against the Pallas butterfly
    on the same (l, r, twiddle) triples."""
    from aes_zero_knowledge_proof_circuit_tpu.ops.pallas_field import (
        pallas_butterfly,
    )

    n, half = 16, 4
    vals = rand_ints(8, n)
    tw = rand_ints(9, n // 2)
    # stage log2(half) = 2 alone: a pass of one stage at t0 = 2
    x = N.plain_pass(P.dpoly(vals, "cpu"), P.dpoly(tw, "cpu"), 4, 2, 1,
                     bitrev=False)
    stride = n // (2 * half)
    for g0 in range(0, n, 2 * half):
        lv = vals[g0:g0 + half]
        rv = vals[g0 + half:g0 + 2 * half]
        tv = [tw[j * stride] for j in range(half)]
        hi, lo = pallas_butterfly(G, jdig(lv), jdig(rv), jdig(tv),
                                  interpret=INTERP)
        assert F.to_ints(x[g0:g0 + half]) == digits_to_ints(G, hi)
        assert F.to_ints(x[g0 + half:g0 + 2 * half]) == digits_to_ints(G, lo)


def test_coset_ntt_matches_poly_jax():
    log_n, g = 6, 7
    vals = rand_ints(10, 40)
    got = P.ntt_coset(log_n, P.dpoly(vals, "cpu"), g)
    assert F.to_ints(got) == digits_to_ints(
        G, poly_jax.ntt_coset(log_n, jdig(vals), g))
    back = P.intt_coset(log_n, got, g)
    assert F.to_ints(back) == vals + [0] * (64 - 40)


def test_powers_and_tree_sum_match_poly_jax():
    z = rand_ints(11, 1)[0]
    got = P.powers(P.scalar(z, "cpu"), 37)
    want = poly_jax.powers(jdig([z])[0], 37)
    assert F.to_ints(got) == digits_to_ints(G, want)
    vals = rand_ints(12, 300)
    assert F.to_ints(P.tree_sum(P.dpoly(vals, "cpu"))) == digits_to_ints(
        G, poly_jax.tree_sum(jdig(vals))[None, :])


def test_prefix_sums_match_hillis_scan():
    vals = rand_ints(13, 100)
    x = P.dpoly(vals, "cpu")
    want = digits_to_ints(G, hillis_scan(G.add, jdig(vals)))
    assert F.to_ints(P.prefix_sum(x)) == want
    want_rev = digits_to_ints(G, hillis_scan(G.add, jdig(vals), reverse=True))
    assert F.to_ints(P.prefix_sum(x, reverse=True)) == want_rev


@pytest.mark.parametrize("length,m", [(100, 16), (64, 16), (10, 16), (48, 4)])
def test_div_vanishing_matches_poly_jax(length, m):
    vals = rand_ints(14 + length, length)
    h, rem = P.div_vanishing(P.dpoly(vals, "cpu"), m)
    hj, rj = poly_jax.div_vanishing(jdig(vals), m)
    assert F.to_ints(h) == digits_to_ints(G, hj)
    assert F.to_ints(rem) == digits_to_ints(G, rj)
    hh, rr = poly_host.poly_div_vanishing(vals, m)
    assert F.to_ints(h)[:len(hh)] == hh
    assert F.to_ints(rem)[:len(rr)] == rr


def test_segment_sum_mod_matches_poly_jax():
    vals = rand_ints(15, 500)
    ids = np.random.default_rng(16).integers(0, 37, size=500)
    got = P.segment_sum_mod(P.dpoly(vals, "cpu"), torch.as_tensor(ids), 37)
    want = poly_jax.segment_sum_mod(jdig(vals), jnp.asarray(ids, jnp.int32),
                                    37)
    assert F.to_ints(got) == digits_to_ints(G, want)


def test_fold_wide_takes_the_top_carry():
    """Sums that overflow 2^256 (many elements near r) reduce exactly."""
    vals = [R_MOD - 1 - i for i in range(4096)]
    assert F.to_ints(P.tree_sum(P.dpoly(vals, "cpu"))) == [sum(vals) % R_MOD]
