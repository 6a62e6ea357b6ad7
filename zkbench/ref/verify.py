"""The Marlin verifier, with the SRS's secret exponent as its pairing.

The transcript replay and the AHP identities (the outer sumcheck over H,
each matrix's inner sumcheck over K, the degree bounds through shifted
evaluations) follow the port's `marlin/verifier.py` line for line. The
two batched KZG checks are where this verifier differs: the program's
checks e(A, H) = e(W, tau H - z H), with A = C - v G - r gamma G, and
since e(., H) is one-to-one on the order-r subgroup (every point of a
parsed proof lies in it) that holds exactly when A = (tau - z) W. The
reference knows tau (`index.srs_secrets`), so it checks that equation in
G1, which accepts and refuses the same proofs as the pairings, at a
fraction of their host time.
"""

from __future__ import annotations

from typing import List, Sequence

from .field import G, Point, R_MOD, combine
from .index import RefKey, at_tau
from .proof import Proof
from .transcript import Transcript


def _absorb_key(t: Transcript, key: RefKey) -> None:
    t.absorb_u64(b"log_n", key.log_n)
    t.absorb_u64(b"log_x", key.log_x)
    t.absorb_u64(b"num_instance", key.num_instance)
    for lk in key.log_ks:
        t.absorb_u64(b"log_k", lk)
    t.absorb_u64(b"max_degree", key.max_degree)
    for c in key.index_comms:
        t.absorb_g1(b"index_comm", c)


def opening_holds(key: RefKey, comms: Sequence[Point], z: int,
                  values: Sequence[int], opening, xi: int) -> bool:
    """sum_i xi^i (C_i - v_i G) - r gamma G - (tau - z) W is infinity."""
    w, rand = opening
    scalars, comb_v, xi_pow = [], 0, 1
    for v in values:
        scalars.append(xi_pow)
        comb_v = (comb_v + xi_pow * v) % R_MOD
        xi_pow = xi_pow * xi % R_MOD
    total = combine(list(comms) + [G, key.gamma_g, w],
                    scalars + [-comb_v, -rand, -(key.tau - z)])
    return total is None


def verify(key: RefKey, instance: Sequence[int], proof: Proof) -> bool:
    if not instance or instance[0] != 1 or len(instance) != key.num_instance:
        return False
    if len(proof.sigmas) != 3 or len(proof.evals_beta2) != 3 \
            or len(proof.evals_beta1) != 7 \
            or any(len(e) != 5 for e in proof.evals_beta2):
        return False
    n = 1 << key.log_n
    x_size = 1 << key.log_x
    d_max = key.max_degree
    cw, cza, czb, cs, ct, cg1, cg1s, ch1 = proof.comms

    t = Transcript()
    _absorb_key(t, key)
    t.absorb_fr_list(b"instance", instance)
    for lbl, c in ((b"w", cw), (b"za", cza), (b"zb", czb), (b"s", cs)):
        t.absorb_g1(lbl, c)
    alpha = t.challenge_fr(b"alpha")
    eta_a = t.challenge_fr(b"eta_a")
    eta_b = t.challenge_fr(b"eta_b")
    eta_c = t.challenge_fr(b"eta_c")
    for lbl, c in ((b"t", ct), (b"g1", cg1), (b"g1s", cg1s), (b"h1", ch1)):
        t.absorb_g1(lbl, c)
    beta1 = t.challenge_fr(b"beta1")
    for sigma, cg2, cg2s, ch2 in zip(proof.sigmas, proof.comm_g2,
                                     proof.comm_g2_shift, proof.comm_h2):
        t.absorb_fr(b"sigma", sigma)
        t.absorb_g1(b"g2", cg2)
        t.absorb_g1(b"g2s", cg2s)
        t.absorb_g1(b"h2", ch2)
    beta2 = t.challenge_fr(b"beta2")
    t.absorb_fr_list(b"evals_beta1", proof.evals_beta1)
    for e in proof.evals_beta2:
        t.absorb_fr_list(b"evals_beta2", e)
    xi1 = t.challenge_fr(b"xi1")
    xi2 = t.challenge_fr(b"xi2")

    w_e, za_e, zb_e, s_e, t_e, g1_e, h1_e = proof.evals_beta1
    padded = list(instance) + [0] * (x_size - len(instance))
    try:
        x_e = at_tau([padded], key.log_x, beta1)[0]
    except ValueError:           # beta1 in X: the value is the instance's
        return False
    v_x_beta1 = (pow(beta1, x_size, R_MOD) - 1) % R_MOD
    z_e = (w_e * v_x_beta1 + x_e) % R_MOD
    v_h_alpha = (pow(alpha, n, R_MOD) - 1) % R_MOD
    v_h_beta1 = (pow(beta1, n, R_MOD) - 1) % R_MOD
    if (alpha - beta1) % R_MOD == 0:
        return False
    r_ab = (v_h_alpha - v_h_beta1) * pow(alpha - beta1, -1, R_MOD) % R_MOD
    p_e = (eta_a * za_e + eta_b * zb_e + eta_c * za_e % R_MOD * zb_e) % R_MOD
    if (s_e + r_ab * p_e - t_e * z_e) % R_MOD != \
            (h1_e * v_h_beta1 + beta1 * g1_e) % R_MOD:
        return False

    scale = v_h_alpha * v_h_beta1 % R_MOD
    for log_k, sigma, evals in zip(key.log_ks, proof.sigmas,
                                   proof.evals_beta2):
        k = 1 << log_k
        row_e, col_e, val_e, g2_e, h2_e = evals
        b_e = (alpha - row_e) * (beta1 - col_e) % R_MOD
        a_e = scale * val_e % R_MOD
        f_e = (beta2 * g2_e + sigma * pow(k, -1, R_MOD)) % R_MOD
        v_k_beta2 = (pow(beta2, k, R_MOD) - 1) % R_MOD
        if (a_e - b_e * f_e) % R_MOD != h2_e * v_k_beta2 % R_MOD:
            return False
    if (eta_a * proof.sigmas[0] + eta_b * proof.sigmas[1]
            + eta_c * proof.sigmas[2]) % R_MOD != t_e:
        return False

    g1_shift = d_max - (n - 2)
    beta1_values = [w_e, za_e, zb_e, s_e, t_e, g1_e,
                    pow(beta1, g1_shift, R_MOD) * g1_e % R_MOD, h1_e]
    if not opening_holds(key, proof.comms, beta1, beta1_values,
                         proof.openings[0], xi1):
        return False
    beta2_comms: List[Point] = []
    beta2_values: List[int] = []
    for mi, (log_k, evals) in enumerate(zip(key.log_ks, proof.evals_beta2)):
        k = 1 << log_k
        row_e, col_e, val_e, g2_e, h2_e = evals
        beta2_comms += key.index_comms[3 * mi:3 * mi + 3] + [
            proof.comm_g2[mi], proof.comm_g2_shift[mi], proof.comm_h2[mi]]
        beta2_values += [row_e, col_e, val_e, g2_e,
                         pow(beta2, d_max - (k - 2), R_MOD) * g2_e % R_MOD,
                         h2_e]
    return opening_holds(key, beta2_comms, beta2, beta2_values,
                         proof.openings[1], xi2)
