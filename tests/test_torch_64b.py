"""The port's 64-byte (four-block) AES-128 ECB path against the JAX package,
on the CPU with zero tolerance: the template (counts and the three
matrices' COO arrays), the SRS degree and the domain sizes the indexer
derives from it (n = 2^20, largest k = 2^21, SRS 2^22), the witness the
port's evaluator fills, the instance a proof is checked against and the
NTT's pass split at 2^22; also chip_smoke's count of K4's level items (its
bound where the plain version does not run) and the SRS checkpoint that
both packages read. One module-scoped build of each package's 64-byte ECB
template (about 20 s each) serves the template tests."""

import random
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke
from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer as jax_indexer
from aes_zero_knowledge_proof_circuit_tpu.models.aes_circuit import (
    build_template as jax_build_template,
)
from aes_zero_knowledge_proof_circuit_tpu.utils import serialize as jax_ser
from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import pass_widths
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import srs as tsrs
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.serialize import save_srs
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

LENGTH = 64


def random_bytes(seed: int, n: int) -> bytes:
    gen = np.random.default_rng(seed)
    return gen.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    """(the port's 64-byte ECB template, the JAX package's), the port's
    cached in a directory of this module's own."""
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    try:
        yield (api._template_cached(LENGTH, "ecb"),
               jax_build_template(LENGTH))
    finally:
        api.CONFIG.cache_dir = old


def test_template_counts_match_reference(templates):
    tpl, ref = templates
    got, want = tpl.r1cs, ref.r1cs
    assert (tpl.mode, tpl.msg_len) == ("ecb", LENGTH)
    assert (got.num_constraints, got.num_variables, got.num_instance) == \
        (want.num_constraints, want.num_variables, want.num_instance) == \
        (585_656, 585_145, 1 + 8 * LENGTH)
    assert got.nnz() == want.nnz() == (586_180, 1_060_848, 1_201_948)


@pytest.mark.parametrize("matrix", [0, 1, 2], ids=["A", "B", "C"])
def test_template_coo_matches_reference(templates, matrix):
    tpl, ref = templates
    rows, cols, vals = tpl.r1cs.matrices_coo()[matrix]
    ref_rows, ref_cols, ref_vals = ref.r1cs.matrices_coo()[matrix]
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(cols, ref_cols)
    assert list(vals) == list(ref_vals)


def test_srs_degree_and_domains_match_reference(templates):
    """The key's SRS degree is the reference's capacity, 2^22, and the
    domains the port's indexer derives (|X|, n = |H|, each matrix's k) are
    the JAX indexer's, taken from the same R1CS without committing."""
    tpl, ref = templates
    r = ref.r1cs
    want = jax_indexer.required_degree(r.num_constraints, r.num_variables,
                                       max(r.nnz()))
    assert api._srs_degree(tpl) == want == 1 << 22
    log_x, log_n, var_to_slot = indexer.var_slots(tpl.r1cs)
    assert log_x == jax_indexer._next_pow2_log(r.num_instance) == 10
    assert log_n == 20
    assert (1 << log_n) - (1 << log_x) >= r.num_witness
    log_ks = [indexer._next_pow2_log(nnz) for nnz in tpl.r1cs.nnz()]
    assert log_ks == [jax_indexer._next_pow2_log(nnz) for nnz in r.nnz()]
    assert log_ks == [20, 21, 21]
    # instance variable j at H[j n / |X|], every slot distinct
    stride = 1 << (log_n - log_x)
    assert var_to_slot[:r.num_instance] == list(range(0, r.num_instance *
                                                       stride, stride))
    assert len(set(var_to_slot)) == len(var_to_slot)


@pytest.mark.parametrize("seed", [1, 2])
def test_witness_matches_reference(templates, seed):
    """z from the port's evaluator for a random 64-byte message equals the
    JAX template's host witness; its ciphertext bits are the oracle's four
    blocks and it satisfies the R1CS."""
    tpl, ref = templates
    msg, key = random_bytes(seed, LENGTH), random_bytes(seed + 100, 16)
    ev = WitnessEvaluator(tpl.plan, "cpu")
    z = ev.evaluate_batch(api._witness_bits(tpl, [msg], key))[0]
    np.testing.assert_array_equal(z.numpy(), ref.witness_z(msg, key))
    ct = api.compute_ciphertext(msg, key)
    assert len(ct) == LENGTH
    assert ct[48:] == api.compute_ciphertext(msg[48:], key)
    assert z[1:tpl.r1cs.num_instance].tolist() == api.bits_lsb_first(ct)
    assert tpl.r1cs.is_satisfied(z.tolist())


def test_encrypt_hands_the_prover_the_verifier_instance(templates,
                                                        monkeypatch):
    tpl, _ref = templates
    msg, key = random_bytes(3, LENGTH), random_bytes(4, 16)
    ct = api.compute_ciphertext(msg, key)
    seen = []
    monkeypatch.setattr(api._verifier, "verify",
                        lambda vk, inst, proof: seen.append(inst) or True)
    assert api.verify_encryption(None, None, ct)
    assert seen[0] == [1] + api.bits_lsb_first(ct)

    class Recorder:
        def prove(self, instance, witness, rng=None, zk=True):
            return instance, witness

    pk = api.AESProvingKey(marlin_pk=None, template=tpl,
                           device=torch.device("cpu"), _prover=Recorder())
    instance, witness = api.encrypt(msg, key, pk)
    assert instance == seen[0]
    n_inst = tpl.r1cs.num_instance
    z = WitnessEvaluator(tpl.plan, "cpu").evaluate_batch(
        api._witness_bits(tpl, [msg], key))[0]
    assert torch.equal(witness, z[n_inst:])


@pytest.mark.parametrize("log_n,widths", [(20, [10, 10]), (21, [7, 7, 7]),
                                          (22, [8, 7, 7])])
def test_ntt_pass_widths(log_n, widths):
    """The 64-byte path's NTT sizes: 2^20 in two passes, the round-3
    cosets' 2^21 and 2^22 in three."""
    assert pass_widths(log_n) == widths


@pytest.mark.parametrize("lanes", [1, 8], ids=["all_levels", "lanes8"])
def test_landing_kinds_match_the_plain_levels(lanes):
    """chip_smoke's count of K4's level items from the landing alone (the
    bound of its MSMs past 2^20, where the plain version is not run) equals
    the plain levels' count on points with no infinity and no negated
    pair: pairs are the adds and doublings, the odd carries the copies."""
    f = fr_ops()
    srs = generate_srs_native(255, random.Random(3))
    base = M.points_from_packed(srs.powers_g1.packed, "cpu")
    points = base.repeat(2, 1, 1)[:300].contiguous()   # repeats: doublings
    gen = np.random.default_rng(5)
    scalars = chip_smoke.random_elements(f, 296, gen, "cpu")
    plan = MP.land(MD.digit_limbs(scalars), lanes)
    kinds = {}
    MP.plain_scan_msm(points, plan, kinds)
    counted = chip_smoke.landing_kinds(plan)
    assert plan.levels > 1
    assert counted["add"] == sum(kinds.get(k, 0) for k in ("add", "dbl",
                                                            "cancel"))
    assert counted["copy"] == kinds.get("copy", 0)


def test_srs_checkpoint_round_trips_through_the_reference(tmp_path):
    """The port stores its SRS checkpoint uncompressed (the 2^22 one is
    loaded again by every smaller key); the JAX package loads it, and the
    port loads the JAX package's compressed one: the same powers, gamma
    powers, h and tau h both ways."""
    srs = generate_srs_native(63, random.Random(3))
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_srs(str(ours), srs)
    with zipfile.ZipFile(ours) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    ref = jax_ser.load_srs(str(ours))
    np.testing.assert_array_equal(ref.powers_g1.packed, srs.powers_g1.packed)
    jax_ser.save_srs(str(theirs), ref)
    with zipfile.ZipFile(theirs) as z:
        assert zipfile.ZIP_DEFLATED in {i.compress_type for i in z.infolist()}
    back = tsrs.load_srs(str(theirs))
    assert back.max_degree == srs.max_degree == 63
    np.testing.assert_array_equal(back.powers_g1.packed, srs.powers_g1.packed)
    assert list(back.gamma_powers_g1) == list(srs.gamma_powers_g1)
    assert (back.h, back.tau_h) == (srs.h, srs.tau_h)
