"""Plonk prover/verifier over the shared KZG commitment layer.

Implements the vanilla Plonk protocol (GWC19) end-to-end — preprocessing,
5-round prover with full zero-knowledge blinding, and the pairing-check
verifier — on BLS12-377, reusing this stack's commitment machinery
(`ops/kzg.py` SRS + commit, `ops/poly_host.py` domains, the blake2s
Fiat-Shamir transcript, `ops/pairing_host.py`). This is the
commitment-layer reuse the reference's roadmap implies (reference
README.md:5 "Plonk backend"; SURVEY.md §7 step 10): the same universal
powers-of-tau SRS serves both Marlin and Plonk.

Host-tier polynomial arithmetic: Plonk here targets the gadget/demo
circuit sizes (tests mirror src/ops.rs's xor/add demos); AES-scale Plonk
would lift the same round structure onto the device NTT/MSM kernels the
Marlin prover uses.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..ops import kzg
from ..ops.field_params import R_MOD, inv_mod
from ..ops.msm_host import msm as _host_msm
from ..ops.pairing_host import multi_pairing
from ..ops.poly_host import (
    domain,
    poly_add,
    poly_div_linear,
    poly_div_vanishing,
    poly_eval,
    poly_mul,
    poly_scale,
    poly_sub,
)
from ..utils.errors import ProofError, require
from ..utils.transcript import Transcript
from .circuit import PlonkCircuit, PlonkCircuitData


@dataclass
class PlonkProvingKey:
    data: PlonkCircuitData
    srs: kzg.SRS
    selector_polys: List[List[int]]
    s_sigma_polys: List[List[int]]
    vk: "PlonkVerifyingKey"


@dataclass
class PlonkVerifyingKey:
    n: int
    omega: int
    ks: tuple
    num_public: int
    comm_selectors: List[kzg.Commitment]   # qL qR qO qM qC
    comm_s_sigma: List[kzg.Commitment]     # 3 columns
    kzg_vk: kzg.VerifierKey


@dataclass
class PlonkProof:
    comm_a: kzg.Commitment
    comm_b: kzg.Commitment
    comm_c: kzg.Commitment
    comm_z: kzg.Commitment
    comm_t: List[kzg.Commitment]           # t_lo, t_mid, t_hi
    eval_a: int
    eval_b: int
    eval_c: int
    eval_s1: int
    eval_s2: int
    eval_zw: int
    w_zeta: kzg.Commitment
    w_zeta_omega: kzg.Commitment


def _transcript(vk: PlonkVerifyingKey, public_values: Sequence[int]) -> Transcript:
    t = Transcript(domain_sep=b"zkaes-tpu-plonk-v1")
    t.absorb_u64(b"n", vk.n)
    for c in vk.comm_selectors + vk.comm_s_sigma:
        t.absorb_g1(b"pre", c.point)
    t.absorb_fr_list(b"public", public_values)
    return t


def setup(circuit: PlonkCircuit, srs: Optional[kzg.SRS] = None,
          rng: Optional[_random.Random] = None) -> PlonkProvingKey:
    """Preprocess: interpolate selector/sigma polynomials and commit them.

    Accepts any universal KZG SRS with max_degree >= n + 5 (the blinded
    z poly has degree n + 2; the quotient split parts degree <= n + 5) —
    in particular the Marlin SRS checkpoints are reusable as-is."""
    data = circuit.compile()
    n = data.n
    if srs is None:
        srs = kzg.setup(4 * n + 6, rng or _random.Random(0))
    require(srs.max_degree >= n + 5, ProofError, "SRS too small for circuit")
    d = domain(data.log_n)
    selector_polys = [d.intt(col) for col in data.selector_evals]
    s_sigma_polys = [d.intt(col) for col in data.s_sigma_evals]
    comm_sel = [kzg.commit(srs, p)[0] for p in selector_polys]
    comm_sig = [kzg.commit(srs, p)[0] for p in s_sigma_polys]
    vk = PlonkVerifyingKey(
        n=n, omega=data.omega, ks=data.ks, num_public=data.num_public,
        comm_selectors=comm_sel, comm_s_sigma=comm_sig,
        kzg_vk=srs.verifier_part(),
    )
    return PlonkProvingKey(data=data, srs=srs,
                           selector_polys=selector_polys,
                           s_sigma_polys=s_sigma_polys, vk=vk)


def _mul_zh(p: Sequence[int], n: int) -> List[int]:
    """p * (X^n - 1)."""
    return poly_sub([0] * n + list(p), p)


def prove(pk: PlonkProvingKey, assignment: Dict[int, int],
          public_values: Sequence[int], circuit: PlonkCircuit,
          rng: Optional[_random.Random] = None) -> PlonkProof:
    rng = rng or _random.Random()
    data, srs = pk.data, pk.srs
    n, omega, (k1_, k2_, k3_) = data.n, data.omega, data.ks
    d = domain(data.log_n)
    wa, wb, wc = circuit.wire_columns(assignment, public_values)
    pi_evals = [(-public_values[j]) % R_MOD if j < data.num_public else 0
                for j in range(n)]
    pi_poly = d.intt(pi_evals)

    # ---- round 1: blinded wire polynomials -------------------------------
    def blind(evals: List[int], nblind: int) -> List[int]:
        base = d.intt(evals)
        bl = [rng.randrange(R_MOD) for _ in range(nblind)]
        return poly_add(base, _mul_zh(bl, n))

    a_poly = blind(wa, 2)
    b_poly = blind(wb, 2)
    c_poly = blind(wc, 2)
    t = _transcript(pk.vk, public_values)
    comm_a = kzg.commit(srs, a_poly)[0]
    comm_b = kzg.commit(srs, b_poly)[0]
    comm_c = kzg.commit(srs, c_poly)[0]
    for lbl, c in ((b"a", comm_a), (b"b", comm_b), (b"c", comm_c)):
        t.absorb_g1(lbl, c.point)
    beta = t.challenge_fr(b"beta")
    gamma = t.challenge_fr(b"gamma")

    # ---- round 2: permutation grand product ------------------------------
    omega_pows = [1] * n
    for j in range(1, n):
        omega_pows[j] = omega_pows[j - 1] * omega % R_MOD
    s1e, s2e, s3e = data.s_sigma_evals
    z_evals = [1]
    acc = 1
    for j in range(n - 1):
        num = ((wa[j] + beta * omega_pows[j] + gamma)
               * (wb[j] + beta * k2_ * omega_pows[j] + gamma)
               * (wc[j] + beta * k3_ * omega_pows[j] + gamma)) % R_MOD
        den = ((wa[j] + beta * s1e[j] + gamma)
               * (wb[j] + beta * s2e[j] + gamma)
               * (wc[j] + beta * s3e[j] + gamma)) % R_MOD
        acc = acc * num % R_MOD * inv_mod(den, R_MOD) % R_MOD
        z_evals.append(acc)
    z_poly = poly_add(d.intt(z_evals),
                      _mul_zh([rng.randrange(R_MOD) for _ in range(3)], n))
    comm_z = kzg.commit(srs, z_poly)[0]
    t.absorb_g1(b"z", comm_z.point)
    alpha = t.challenge_fr(b"alpha")

    # ---- round 3: quotient -----------------------------------------------
    ql, qr, qo, qm, qc = pk.selector_polys
    gate = poly_add(
        poly_add(poly_mul(poly_mul(a_poly, b_poly), qm),
                 poly_add(poly_mul(a_poly, ql), poly_mul(b_poly, qr))),
        poly_add(poly_mul(c_poly, qo), poly_add(pi_poly, qc)),
    )
    lin_a = poly_add(a_poly, [gamma, beta])
    lin_b = poly_add(b_poly, [gamma, beta * k2_ % R_MOD])
    lin_c = poly_add(c_poly, [gamma, beta * k3_ % R_MOD])
    perm1 = poly_mul(poly_mul(poly_mul(lin_a, lin_b), lin_c), z_poly)
    s1p, s2p, s3p = pk.s_sigma_polys
    pa = poly_add(a_poly, poly_add(poly_scale(s1p, beta), [gamma]))
    pb = poly_add(b_poly, poly_add(poly_scale(s2p, beta), [gamma]))
    pc = poly_add(c_poly, poly_add(poly_scale(s3p, beta), [gamma]))
    z_shift = [z_poly[i] * pow(omega, i, R_MOD) % R_MOD
               for i in range(len(z_poly))]
    perm2 = poly_mul(poly_mul(poly_mul(pa, pb), pc), z_shift)
    # L1(X): 1 at omega^0, 0 elsewhere
    l1_poly = d.intt([1] + [0] * (n - 1))
    start = poly_mul(poly_add(z_poly, [-1]), l1_poly)
    numer = poly_add(
        gate,
        poly_add(poly_scale(poly_sub(perm1, perm2), alpha),
                 poly_scale(start, alpha * alpha % R_MOD)),
    )
    t_poly, rem = poly_div_vanishing(numer, n)
    require(not any(rem), ProofError, "quotient division not exact")
    # split into three parts with zk stitching scalars b10, b11
    b10 = rng.randrange(R_MOD)
    b11 = rng.randrange(R_MOD)
    t_poly = t_poly + [0] * (3 * n + 6 - len(t_poly))
    t_lo = t_poly[:n] + [b10]
    t_mid = ([(t_poly[n] - b10) % R_MOD] + t_poly[n + 1 : 2 * n] + [b11])
    t_hi = [(t_poly[2 * n] - b11) % R_MOD] + t_poly[2 * n + 1 :]
    comm_t = [kzg.commit(srs, p)[0] for p in (t_lo, t_mid, t_hi)]
    for c in comm_t:
        t.absorb_g1(b"t", c.point)
    zeta = t.challenge_fr(b"zeta")

    # ---- round 4: evaluations --------------------------------------------
    ev_a = poly_eval(a_poly, zeta)
    ev_b = poly_eval(b_poly, zeta)
    ev_c = poly_eval(c_poly, zeta)
    ev_s1 = poly_eval(s1p, zeta)
    ev_s2 = poly_eval(s2p, zeta)
    ev_zw = poly_eval(z_poly, zeta * omega % R_MOD)
    for lbl, e in ((b"a", ev_a), (b"b", ev_b), (b"c", ev_c),
                   (b"s1", ev_s1), (b"s2", ev_s2), (b"zw", ev_zw)):
        t.absorb_fr(lbl, e)
    v = t.challenge_fr(b"v")
    # NOTE: the multipoint challenge u is drawn only AFTER the round-5
    # opening commitments W_zeta/W_zeta_omega are absorbed (GWC19 round
    # ordering). Drawing it here would let a malicious prover choose the
    # W commitments as a function of u and forge openings; the prover
    # itself never needs u, so it is derived by the verifier only.

    # ---- round 5: linearization + openings -------------------------------
    zh_zeta = (pow(zeta, n, R_MOD) - 1) % R_MOD
    l1_zeta = poly_eval(l1_poly, zeta)
    r_poly = poly_add(
        poly_add(
            poly_add(poly_scale(qm, ev_a * ev_b % R_MOD),
                     poly_add(poly_scale(ql, ev_a), poly_scale(qr, ev_b))),
            poly_add(poly_scale(qo, ev_c), qc),
        ),
        poly_scale(
            z_poly,
            (alpha
             * ((ev_a + beta * zeta + gamma) % R_MOD)
             * ((ev_b + beta * k2_ * zeta + gamma) % R_MOD)
             * ((ev_c + beta * k3_ * zeta + gamma) % R_MOD)
             + alpha * alpha % R_MOD * l1_zeta) % R_MOD,
        ),
    )
    r_poly = poly_sub(
        r_poly,
        poly_scale(
            s3p,
            alpha * beta % R_MOD * ev_zw % R_MOD
            * ((ev_a + beta * ev_s1 + gamma) % R_MOD)
            * ((ev_b + beta * ev_s2 + gamma) % R_MOD) % R_MOD,
        ),
    )
    # split boundaries are at n and 2n coefficients -> stitch with zeta^n
    t_comb = poly_add(poly_add(t_lo, poly_scale(t_mid, pow(zeta, n, R_MOD))),
                      poly_scale(t_hi, pow(zeta, 2 * n, R_MOD)))
    r_poly = poly_sub(r_poly, poly_scale(t_comb, zh_zeta))
    # self-check: r(zeta) == -r0 (constant part the verifier recomputes)
    r0 = (poly_eval(pi_poly, zeta)
          - l1_zeta * alpha * alpha
          - alpha * ((ev_a + beta * ev_s1 + gamma) % R_MOD)
          * ((ev_b + beta * ev_s2 + gamma) % R_MOD)
          * ((ev_c + gamma) % R_MOD) * ev_zw) % R_MOD
    require(poly_eval(r_poly, zeta) == (-r0) % R_MOD, ProofError,
            "linearization self-check failed")

    comb = poly_add(r_poly, [r0])  # evaluates to 0 at zeta
    vp = 1
    for p, e in ((a_poly, ev_a), (b_poly, ev_b), (c_poly, ev_c),
                 (s1p, ev_s1), (s2p, ev_s2)):
        vp = vp * v % R_MOD
        comb = poly_add(comb, poly_scale(poly_sub(p, [e]), vp))
    w_zeta_poly, rem0 = poly_div_linear(comb, zeta)
    require(rem0 == 0, ProofError, "opening remainder at zeta")
    w_zw_poly, _remw = poly_div_linear(poly_sub(z_poly, [ev_zw]),
                                       zeta * omega % R_MOD)
    w_zeta = kzg.commit(srs, w_zeta_poly)[0]
    w_zeta_omega = kzg.commit(srs, w_zw_poly)[0]
    return PlonkProof(
        comm_a=comm_a, comm_b=comm_b, comm_c=comm_c, comm_z=comm_z,
        comm_t=comm_t, eval_a=ev_a, eval_b=ev_b, eval_c=ev_c,
        eval_s1=ev_s1, eval_s2=ev_s2, eval_zw=ev_zw,
        w_zeta=w_zeta, w_zeta_omega=w_zeta_omega,
    )


def _pt_scale(p, k: int):
    return _host_msm([p], [k % R_MOD])


def verify(vk: PlonkVerifyingKey, proof: PlonkProof,
           public_values: Sequence[int]) -> bool:
    n, omega = vk.n, vk.omega
    k1_, k2_, k3_ = vk.ks
    require(len(public_values) == vk.num_public, ProofError,
            "public input count mismatch")
    t = _transcript(vk, public_values)
    for lbl, c in ((b"a", proof.comm_a), (b"b", proof.comm_b),
                   (b"c", proof.comm_c)):
        t.absorb_g1(lbl, c.point)
    beta = t.challenge_fr(b"beta")
    gamma = t.challenge_fr(b"gamma")
    t.absorb_g1(b"z", proof.comm_z.point)
    alpha = t.challenge_fr(b"alpha")
    for c in proof.comm_t:
        t.absorb_g1(b"t", c.point)
    zeta = t.challenge_fr(b"zeta")
    for lbl, e in ((b"a", proof.eval_a), (b"b", proof.eval_b),
                   (b"c", proof.eval_c), (b"s1", proof.eval_s1),
                   (b"s2", proof.eval_s2), (b"zw", proof.eval_zw)):
        t.absorb_fr(lbl, e)
    v = t.challenge_fr(b"v")
    # u binds the two opening proofs together; it MUST be drawn after
    # W_zeta / W_zeta_omega are fixed in the transcript (GWC19), else a
    # prover knowing u in advance can pick W_zeta_omega to cancel false
    # evaluations in the pairing check (see tests/test_plonk.py forgery
    # regression).
    t.absorb_g1(b"wz", proof.w_zeta.point)
    t.absorb_g1(b"wzw", proof.w_zeta_omega.point)
    u = t.challenge_fr(b"u")

    zh_zeta = (pow(zeta, n, R_MOD) - 1) % R_MOD
    if zh_zeta == 0:
        return False  # zeta in H (negligible honestly; reject)
    l1_zeta = (zh_zeta * inv_mod(n * (zeta - 1) % R_MOD, R_MOD)) % R_MOD
    # PI(zeta) via barycentric evaluation over the first ell rows
    pi_zeta = 0
    wj = 1
    n_inv = inv_mod(n, R_MOD)
    for j in range(vk.num_public):
        lj = (zh_zeta * wj % R_MOD
              * inv_mod(n * (zeta - wj) % R_MOD, R_MOD)) % R_MOD
        pi_zeta = (pi_zeta - public_values[j] * lj) % R_MOD
        wj = wj * omega % R_MOD
    del n_inv

    ea, eb, ec = proof.eval_a, proof.eval_b, proof.eval_c
    es1, es2, ezw = proof.eval_s1, proof.eval_s2, proof.eval_zw
    r0 = (pi_zeta
          - l1_zeta * alpha * alpha
          - alpha * ((ea + beta * es1 + gamma) % R_MOD)
          * ((eb + beta * es2 + gamma) % R_MOD)
          * ((ec + gamma) % R_MOD) * ezw) % R_MOD

    qlC, qrC, qoC, qmC, qcC = (c.point for c in vk.comm_selectors)
    s3C = vk.comm_s_sigma[2].point
    # D = linearized commitment combination (paper step 9)
    z_coeff = (alpha
               * ((ea + beta * zeta + gamma) % R_MOD)
               * ((eb + beta * k2_ * zeta + gamma) % R_MOD)
               * ((ec + beta * k3_ * zeta + gamma) % R_MOD)
               + alpha * alpha % R_MOD * l1_zeta + u) % R_MOD
    s3_coeff = (-(alpha * beta % R_MOD * ezw % R_MOD
                  * ((ea + beta * es1 + gamma) % R_MOD)
                  * ((eb + beta * es2 + gamma) % R_MOD))) % R_MOD
    zn2 = pow(zeta, n, R_MOD)
    points = [qmC, qlC, qrC, qoC, qcC, proof.comm_z.point, s3C,
              proof.comm_t[0].point, proof.comm_t[1].point,
              proof.comm_t[2].point]
    scalars = [ea * eb % R_MOD, ea, eb, ec, 1, z_coeff, s3_coeff,
               (-zh_zeta) % R_MOD,
               (-zh_zeta) * zn2 % R_MOD,
               (-zh_zeta) * zn2 % R_MOD * zn2 % R_MOD]
    # F = D + v a + v^2 b + ... ; E accumulates the scalar side
    e_scalar = (-r0) % R_MOD
    vp = 1
    for pt, ev in ((proof.comm_a.point, ea), (proof.comm_b.point, eb),
                   (proof.comm_c.point, ec),
                   (vk.comm_s_sigma[0].point, es1),
                   (vk.comm_s_sigma[1].point, es2)):
        vp = vp * v % R_MOD
        points.append(pt)
        scalars.append(vp)
        e_scalar = (e_scalar + vp * ev) % R_MOD
    e_scalar = (e_scalar + u * ezw) % R_MOD
    # F - E  (E = e_scalar * G)
    points.append(vk.kzg_vk.g)
    scalars.append((-e_scalar) % R_MOD)
    # + zeta W_zeta + u zeta omega W_zw  (the shifted-opening fold)
    points.append(proof.w_zeta.point)
    scalars.append(zeta)
    points.append(proof.w_zeta_omega.point)
    scalars.append(u * zeta % R_MOD * omega % R_MOD)
    rhs = _host_msm(points, scalars)
    lhs = _host_msm([proof.w_zeta.point, proof.w_zeta_omega.point], [1, u])
    # e(lhs, tau H) * e(-rhs, H) == 1
    from ..ops.field_host import Fq12

    f = multi_pairing([(lhs, vk.kzg_vk.tau_h), (rhs.neg(), vk.kzg_vk.h)])
    return f == Fq12.one()
