"""The Plonk verifier, with the SRS's secret exponent as its pairing.

The transcript (domain b"zkaes-tpu-plonk-v1": n, the eight preprocessed
commitments, the public values, then each round's commitments,
evaluations and challenges) and the linearisation follow the port's
`plonk/backend.py` `verify` line for line. Its pairing check is
e(W_z + u W_zw, tau H) = e(F - E G + z W_z + u z omega W_zw, H), which
holds exactly when the two points are equal times tau; the reference
knows tau (`index.srs_secrets`), so it checks in G1 that

    F - E G = (tau - z) W_z + u (tau - z omega) W_zw,

the two KZG openings (at z and at z omega) batched by u, as `ref/verify.py`
checks Marlin's. It accepts and refuses the same proofs as the pairings.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..field import G, R_MOD, combine
from ..transcript import Transcript
from .key import PlonkRefKey
from .proof import PlonkProof

DOMAIN = b"zkaes-tpu-plonk-v1"


def _transcript(key: PlonkRefKey, public_values: Sequence[int]
                ) -> Transcript:
    t = Transcript(domain_sep=DOMAIN)
    t.absorb_u64(b"n", key.n)
    for c in key.comms:
        t.absorb_g1(b"pre", c)
    t.absorb_fr_list(b"public", public_values)
    return t


def _round1(key: PlonkRefKey, public_values: Sequence[int],
            proof: PlonkProof) -> Tuple[Transcript, int, int]:
    """The transcript through the wire commitments, and beta and gamma."""
    t = _transcript(key, public_values)
    for lbl, c in ((b"a", proof.comm_a), (b"b", proof.comm_b),
                   (b"c", proof.comm_c)):
        t.absorb_g1(lbl, c)
    beta = t.challenge_fr(b"beta")
    gamma = t.challenge_fr(b"gamma")
    return t, beta, gamma


def permutation_challenges(key: PlonkRefKey, public_values: Sequence[int],
                           proof: PlonkProof) -> Tuple[int, int]:
    """The beta and gamma the proof's grand product z was made with."""
    _t, beta, gamma = _round1(key, public_values, proof)
    return beta, gamma


def verify(key: PlonkRefKey, public_values: Sequence[int],
           proof: PlonkProof) -> bool:
    n, omega = key.n, key.omega
    _k1, k2_, k3_ = key.ks
    if len(public_values) != key.num_public:
        return False
    t, beta, gamma = _round1(key, public_values, proof)
    t.absorb_g1(b"z", proof.comm_z)
    alpha = t.challenge_fr(b"alpha")
    for c in proof.comm_t:
        t.absorb_g1(b"t", c)
    zeta = t.challenge_fr(b"zeta")
    for lbl, e in ((b"a", proof.eval_a), (b"b", proof.eval_b),
                   (b"c", proof.eval_c), (b"s1", proof.eval_s1),
                   (b"s2", proof.eval_s2), (b"zw", proof.eval_zw)):
        t.absorb_fr(lbl, e)
    v = t.challenge_fr(b"v")
    t.absorb_g1(b"wz", proof.w_zeta)
    t.absorb_g1(b"wzw", proof.w_zeta_omega)
    u = t.challenge_fr(b"u")

    zh_zeta = (pow(zeta, n, R_MOD) - 1) % R_MOD
    if zh_zeta == 0:
        return False
    l1_zeta = zh_zeta * pow(n * (zeta - 1) % R_MOD, -1, R_MOD) % R_MOD
    pi_zeta = 0
    wj = 1
    for j in range(key.num_public):
        lj = zh_zeta * wj % R_MOD * pow(n * (zeta - wj) % R_MOD, -1,
                                        R_MOD) % R_MOD
        pi_zeta = (pi_zeta - public_values[j] * lj) % R_MOD
        wj = wj * omega % R_MOD

    ea, eb, ec = proof.eval_a, proof.eval_b, proof.eval_c
    es1, es2, ezw = proof.eval_s1, proof.eval_s2, proof.eval_zw
    r0 = (pi_zeta
          - l1_zeta * alpha * alpha
          - alpha * ((ea + beta * es1 + gamma) % R_MOD)
          * ((eb + beta * es2 + gamma) % R_MOD)
          * ((ec + gamma) % R_MOD) * ezw) % R_MOD

    ql_c, qr_c, qo_c, qm_c, qc_c, s1_c, s2_c, s3_c = key.comms
    z_coeff = (alpha
               * ((ea + beta * zeta + gamma) % R_MOD)
               * ((eb + beta * k2_ * zeta + gamma) % R_MOD)
               * ((ec + beta * k3_ * zeta + gamma) % R_MOD)
               + alpha * alpha % R_MOD * l1_zeta + u) % R_MOD
    s3_coeff = (-(alpha * beta % R_MOD * ezw % R_MOD
                  * ((ea + beta * es1 + gamma) % R_MOD)
                  * ((eb + beta * es2 + gamma) % R_MOD))) % R_MOD
    zn = pow(zeta, n, R_MOD)
    # D, the linearised commitment
    points = [qm_c, ql_c, qr_c, qo_c, qc_c, proof.comm_z, s3_c] + list(
        proof.comm_t)
    scalars = [ea * eb % R_MOD, ea, eb, ec, 1, z_coeff, s3_coeff,
               -zh_zeta, -zh_zeta * zn, -zh_zeta * zn % R_MOD * zn]
    # F = D + v a + v^2 b + v^3 c + v^4 s1 + v^5 s2, and E's scalar
    e_scalar = -r0
    vp = 1
    for pt, ev in ((proof.comm_a, ea), (proof.comm_b, eb),
                   (proof.comm_c, ec), (s1_c, es1), (s2_c, es2)):
        vp = vp * v % R_MOD
        points.append(pt)
        scalars.append(vp)
        e_scalar = (e_scalar + vp * ev) % R_MOD
    e_scalar = (e_scalar + u * ezw) % R_MOD
    # F - E G - (tau - z) W_z - u (tau - z omega) W_zw is infinity
    points += [G, proof.w_zeta, proof.w_zeta_omega]
    scalars += [-e_scalar, -(key.tau - zeta),
                -u * (key.tau - zeta * omega % R_MOD)]
    return combine(points, scalars) is None
