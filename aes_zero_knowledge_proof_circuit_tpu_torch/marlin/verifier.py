"""Marlin verifier (host-side; ms-to-s scale).

Re-creation of the forked ark-marlin verify at the reference call site
src/lib.rs:130-136 (SURVEY.md §3.4): re-derive Fiat-Shamir challenges, check
the AHP evaluation identities (outer sumcheck over H, per-matrix inner
sumchecks over K_M, degree bounds via shifted evaluations), then two batched
KZG pairing checks.

Public input convention matches the reference exactly: the instance vector is
[1] + ciphertext bits (LSB-first per byte, src/helpers/mod.rs:84-93 ↔
src/lib.rs:282-286), interpolated over the input domain X ⊂ H.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import kzg
from ..ops.field_params import R_MOD, inv_mod
from ..ops.poly_host import domain, poly_eval
from ..utils.transcript import Transcript
from .indexer import MarlinVerifyingKey
from .prover import MarlinProof


def verify(
    vk: MarlinVerifyingKey,
    instance: Sequence[int],
    proof: MarlinProof,
) -> bool:
    if len(instance) > (1 << vk.log_x) or not instance or instance[0] != 1:
        return False
    if len(instance) != vk.num_instance:
        return False
    n = 1 << vk.log_n
    x_size = 1 << vk.log_x
    h = domain(vk.log_n)
    d_max = vk.max_degree

    # ---- replay the transcript ------------------------------------------
    t = Transcript()
    vk.absorb_into(t)
    t.absorb_fr_list(b"instance", instance)
    for lbl, c in (
        (b"w", proof.comm_w),
        (b"za", proof.comm_za),
        (b"zb", proof.comm_zb),
        (b"s", proof.comm_s),
    ):
        t.absorb_g1(lbl, c.point)
    alpha = t.challenge_fr(b"alpha")
    eta_a = t.challenge_fr(b"eta_a")
    eta_b = t.challenge_fr(b"eta_b")
    eta_c = t.challenge_fr(b"eta_c")
    for lbl, c in (
        (b"t", proof.comm_t),
        (b"g1", proof.comm_g1),
        (b"g1s", proof.comm_g1_shift),
        (b"h1", proof.comm_h1),
    ):
        t.absorb_g1(lbl, c.point)
    beta1 = t.challenge_fr(b"beta1")
    for sigma, cg2, cg2s, ch2 in zip(
        proof.sigmas, proof.comm_g2, proof.comm_g2_shift, proof.comm_h2
    ):
        t.absorb_fr(b"sigma", sigma)
        t.absorb_g1(b"g2", cg2.point)
        t.absorb_g1(b"g2s", cg2s.point)
        t.absorb_g1(b"h2", ch2.point)
    beta2 = t.challenge_fr(b"beta2")
    t.absorb_fr_list(b"evals_beta1", proof.evals_beta1)
    for e in proof.evals_beta2:
        t.absorb_fr_list(b"evals_beta2", e)
    xi1 = t.challenge_fr(b"xi1")
    xi2 = t.challenge_fr(b"xi2")

    # ---- AHP identity checks --------------------------------------------
    w_e, za_e, zb_e, s_e, t_e, g1_e, h1_e = [v % R_MOD for v in proof.evals_beta1]

    # x_hat(beta1) from the public input
    xd = domain(vk.log_x)
    x_poly = xd.intt(list(instance) + [0] * (x_size - len(instance)))
    x_e = poly_eval(x_poly, beta1)
    v_x_beta1 = (pow(beta1, x_size, R_MOD) - 1) % R_MOD
    z_e = (w_e * v_x_beta1 + x_e) % R_MOD

    v_h_alpha = h.vanishing_eval(alpha)
    v_h_beta1 = h.vanishing_eval(beta1)
    if (alpha - beta1) % R_MOD == 0:
        return False
    r_ab = (v_h_alpha - v_h_beta1) * inv_mod((alpha - beta1) % R_MOD, R_MOD) % R_MOD

    p_e = (eta_a * za_e + eta_b * zb_e + eta_c * za_e % R_MOD * zb_e) % R_MOD
    lhs = (s_e + r_ab * p_e - t_e * z_e) % R_MOD
    rhs = (h1_e * v_h_beta1 + beta1 * g1_e) % R_MOD
    if lhs != rhs:
        return False

    # inner sumchecks, per matrix
    if len(proof.sigmas) != 3 or len(proof.evals_beta2) != 3:
        return False
    scale = v_h_alpha * v_h_beta1 % R_MOD
    sigma_sum = 0
    for log_k, sigma, evals in zip(vk.log_ks, proof.sigmas, proof.evals_beta2):
        k = 1 << log_k
        row_e, col_e, val_e, g2_e, h2_e = [v % R_MOD for v in evals]
        b_e = (alpha - row_e) * (beta1 - col_e) % R_MOD
        a_e = scale * val_e % R_MOD
        f_e = (beta2 * g2_e + sigma * inv_mod(k, R_MOD)) % R_MOD
        v_k_beta2 = (pow(beta2, k, R_MOD) - 1) % R_MOD
        if (a_e - b_e * f_e) % R_MOD != h2_e * v_k_beta2 % R_MOD:
            return False
    # eta-weighted sum of sigmas must equal t(beta1)
    sigma_sum = (
        eta_a * proof.sigmas[0] + eta_b * proof.sigmas[1] + eta_c * proof.sigmas[2]
    ) % R_MOD
    if sigma_sum != t_e:
        return False

    # ---- KZG batch checks ------------------------------------------------
    g1_shift = d_max - (n - 2)
    beta1_comms = [
        proof.comm_w,
        proof.comm_za,
        proof.comm_zb,
        proof.comm_s,
        proof.comm_t,
        proof.comm_g1,
        proof.comm_g1_shift,
        proof.comm_h1,
    ]
    beta1_values = [
        w_e,
        za_e,
        zb_e,
        s_e,
        t_e,
        g1_e,
        pow(beta1, g1_shift, R_MOD) * g1_e % R_MOD,  # degree-bound relation
        h1_e,
    ]
    if not kzg.batch_check(
        vk.kzg_vk, beta1_comms, beta1, beta1_values, proof.open_beta1, xi1
    ):
        return False

    beta2_comms: List[kzg.Commitment] = []
    beta2_values: List[int] = []
    for mi, (log_k, evals) in enumerate(zip(vk.log_ks, proof.evals_beta2)):
        k = 1 << log_k
        g2_shift = d_max - (k - 2)
        row_e, col_e, val_e, g2_e, h2_e = [v % R_MOD for v in evals]
        beta2_comms += [
            vk.index_comms[3 * mi + 0],
            vk.index_comms[3 * mi + 1],
            vk.index_comms[3 * mi + 2],
            proof.comm_g2[mi],
            proof.comm_g2_shift[mi],
            proof.comm_h2[mi],
        ]
        beta2_values += [
            row_e,
            col_e,
            val_e,
            g2_e,
            pow(beta2, g2_shift, R_MOD) * g2_e % R_MOD,
            h2_e,
        ]
    if not kzg.batch_check(
        vk.kzg_vk, beta2_comms, beta2, beta2_values, proof.open_beta2, xi2
    ):
        return False

    return True
