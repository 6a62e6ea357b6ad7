"""Plonk prover on device — counterpart of plonk/backend_jax.JaxPlonkProver.

Round for round the host prover plonk/backend.py: the same transcript, the
same masking draws in the same order, so that a proof from a seeded rng
equals the host prover's and JaxPlonkProver's field for field. Every
polynomial lives on one device as [len, 8] Montgomery rows: Fr products,
`batch_inv` and the grand product's `prefix_mul` run kernel K1, the
interpolations at n and the 4n coset transforms kernel K2, and every
commitment is a K3 MSM over the SRS powers held on the device (the JAX
prover commits through the host `kzg.commit`). The host sees commitments,
evaluations and challenges only.

The device arithmetic departs from the host prover's as JaxPlonkProver's
does (same values):
* the quotient is taken on the 4n coset g<w_4n> (the numerator has degree
  4n + 5, t degree 3n + 5 < 4n, so the coset interpolation is exact);
* z(omega X) on the coset is a roll by 4 rows (omega = w_4n^4);
* the grand product is a prefix product of batch-inverted ratios;
* each opening quotient (p(X) - p(z)) / (X - z) is a prefix sum.

`preprocess` is the host `setup` on the device: the eight selector and
sigma columns interpolated with K2 and committed with K3, the same
verifying key. `prove(..., zk=False)` gives every one of the eleven
blinding scalars the value 0 and draws nothing from the rng; zk=True
draws them in the host prover's order (two for each of a, b and c, three
for z, two for the quotient's split).
"""

from __future__ import annotations

import random as _random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kzg
from ..ops import poly as P
from ..ops.field import fr_ops, halves, upload
from ..ops.field_params import R_MOD, fr_multiplicative_generator, inv_mod
from ..ops.msm import msm_point, xyzz_to_affine
from ..ops.poly_host import domain
from ..utils import spans
from ..utils.device import resolve_device
from ..utils.errors import ProofError, require
from ..utils.srs import device_powers
from .backend import (PlonkProof, PlonkProvingKey, PlonkVerifyingKey,
                      _transcript)
from .circuit import PlonkCircuitData

F = fr_ops()
SMALL = 1 << 62
HALF = R_MOD // 2


def field_rows(values: Sequence[int], device) -> torch.Tensor:
    """Host field elements (in [0, r); a list or an array) -> [len, 8]
    Montgomery rows. Through
    F.from_small, as one int64 tensor, where every value is below 2^63 (the
    wires of a boolean circuit) or lies within 2^62 of zero once read as
    signed, v - r above r / 2 (the selectors); else through F.from_ints,
    one Python integer at a time. The upload does not wait for the card
    (`ops.field.upload`)."""
    try:
        small = np.asarray(values, np.int64)
    except OverflowError:
        signed = [v if v <= HALF else v - R_MOD for v in values]
        if max(signed) >= SMALL or min(signed) <= -SMALL:
            return F.from_ints(values, device, non_blocking=True)
        small = np.asarray(signed, np.int64)
    return F.from_small(upload(torch.from_numpy(
        np.ascontiguousarray(small)), device))


def _scalar(v: int, device) -> torch.Tensor:
    """v mod r as a [1, 8] Montgomery row, uploaded without waiting for
    the card."""
    return F.from_ints([v % R_MOD], device, non_blocking=True)


def _blinding(rng, count: int, zk: bool) -> List[int]:
    """`count` blinding scalars drawn from `rng`; with zk off each is 0 and
    nothing is drawn."""
    if not zk:
        return [0] * count
    with spans.span("host.mask_draw", elements=count):
        return [rng.randrange(R_MOD) for _ in range(count)]


def _mul_zh(blind: Sequence[int], n: int, device) -> torch.Tensor:
    """blind(X) * (X^n - 1) as a dpoly of n + len(blind) rows."""
    k = len(blind)
    out = P.zeros(n + k, device)
    out[:k] = F.from_ints([-b for b in blind], device, non_blocking=True)
    out[n:] = F.from_ints(blind, device, non_blocking=True)
    return out


def preprocess(data: PlonkCircuitData, srs: kzg.SRS, device="cuda",
               comms: Optional[Sequence[kzg.Commitment]] = None
               ) -> Tuple[PlonkProvingKey, "TorchPlonkProver"]:
    """`backend.setup` on the device: the key of a compiled circuit over
    `srs` and its prover. The prover interpolates the selector and sigma
    columns (K2); here they are committed (K3, no hiding) over the SRS
    powers the prover holds, so the verifying key equals the host
    setup's point for point. Given `comms`, the eight commitments of an
    earlier preprocess, nothing is committed. The key keeps no host copy
    of the columns (`selector_polys`, `s_sigma_polys` are None): the
    device prover derives its own, and the host prover cannot use it."""
    require(srs.max_degree >= data.n + 5, ProofError,
            "SRS too small for circuit")
    pk = PlonkProvingKey(data=data, srs=srs, selector_polys=None,
                         s_sigma_polys=None, vk=None)
    prover = TorchPlonkProver(pk, device)
    if comms is None:
        comms = prover._commit_batch(prover.sel_polys + prover.sig_polys)
    pk.vk = PlonkVerifyingKey(
        n=data.n, omega=data.omega, ks=data.ks, num_public=data.num_public,
        comm_selectors=list(comms[:5]), comm_s_sigma=list(comms[5:]),
        kzg_vk=srs.verifier_part())
    return pk, prover


class TorchPlonkProver:
    """Device-resident Plonk prover bound to one proving key and one
    device (the CUDA card unless the caller asks for another)."""

    def __init__(self, pk: PlonkProvingKey, device="cuda"):
        self.pk = pk
        self.device = dev = resolve_device(device)
        data = pk.data
        self.n, self.log_n = n, log_n = data.n, data.log_n
        self.log4 = log4 = log_n + 2
        self.omega = data.omega
        self.ks = data.ks
        self.g_cos = fr_multiplicative_generator()
        self.srs_points = device_powers(pk.srs, dev)

        # the static columns from their evaluations: small selectors and
        # the sigma slots' k_i omega^j, interpolated on the device (equal to
        # pk.selector_polys and pk.s_sigma_polys)
        self.omega_pows = P.powers(P.scalar(self.omega, dev), n)
        sel_evals = [field_rows(col, dev) for col in data.selector_evals]
        slots = torch.as_tensor(np.asarray(data.sigma, np.int64), device=dev)
        ks = F.from_ints(data.ks, dev)
        self.sig_evals = [
            F.mul(self.omega_pows[slots[c * n:(c + 1) * n] % n],
                  ks[slots[c * n:(c + 1) * n] // n])
            for c in range(3)]
        self.sel_polys = [P.intt(log_n, e) for e in sel_evals]  # qL .. qC
        self.sig_polys = [P.intt(log_n, e) for e in self.sig_evals]
        l1_evals = P.zeros(n, dev)          # L1: one at omega^0, else zero
        l1_evals[:1] = F.const("one", dev)
        self.l1_poly = P.intt(log_n, l1_evals)
        self.sel_cos = [self._cos(p) for p in self.sel_polys]
        self.sig_cos = [self._cos(p) for p in self.sig_polys]
        self.l1_cos = self._cos(self.l1_poly)
        # x on the 4n coset: g w4^j
        w4 = domain(log4).omega
        self.x_cos = F.mul(P.powers(P.scalar(w4, dev), 1 << log4),
                           P.scalar(self.g_cos, dev))
        # 1 / v_H on the coset: v_H(g w4^j) = g^n i^j - 1 with i = w4^n a
        # 4th root of unity, a cycle of period 4
        gn = pow(self.g_cos, n, R_MOD)
        i4 = pow(w4, n, R_MOD)
        inv_cyc = [inv_mod((gn * pow(i4, j, R_MOD) - 1) % R_MOD, R_MOD)
                   for j in range(4)]
        self.vh_inv_cos = F.from_ints(inv_cyc, dev).repeat((1 << log4) // 4, 1)

    def _cos(self, p: torch.Tensor) -> torch.Tensor:
        return P.ntt_coset(self.log4, p, self.g_cos)

    def _cos_counted(self, p: torch.Tensor) -> torch.Tensor:
        """A proof's coset transform, counted in `coset_ntts`."""
        spans.count("coset_ntts", 1)
        return self._cos(p)

    # -- commitments and evaluations -------------------------------------------

    def _commit_batch(self, polys) -> List[kzg.Commitment]:
        """Commit each dpoly (no hiding, as the host prover): every MSM is
        enqueued before the points come to the host, in one copy."""
        points = xyzz_to_affine(torch.stack(
            [msm_point(self.srs_points, F.to_canonical_limbs(p))
             for p in polys]))
        return [kzg.Commitment(pt) for pt in points]

    @staticmethod
    def _evaluate(pairs, device) -> torch.Tensor:
        """[len(pairs), 8]: p(z) of each (dpoly p, point z), from one table
        of powers a point; summed as `P.tree_sum` sums (exact column sums
        of 16-bit half-limbs), with one `fold_wide` for every pair."""
        m = max(p.shape[0] for p, _ in pairs)
        tables = {}
        for _, z in pairs:
            if z not in tables:
                tables[z] = P.powers(_scalar(z, device), m)
        return P.fold_wide(torch.cat([
            halves(F.mul(p, tables[z][:p.shape[0]])).sum(dim=0, keepdim=True)
            for p, z in pairs]))

    @staticmethod
    def _div_linear(p: torch.Tensor, z: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """((p(X) - p(z)) / (X - z), p(z) as a [1, 8] row) by the prefix-sum
        quotient: w_i = (p(z) - S_i) z^-(i+1), S_i the inclusive prefix sum
        of p_j z^j."""
        dev, ln = p.device, p.shape[0]
        prefix = P.prefix_sum(F.mul(p, P.powers(_scalar(z, dev), ln)))
        zinv = _scalar(inv_mod(z, R_MOD), dev)
        zinv_pows = F.mul(P.powers(zinv, ln), zinv)
        w = F.mul(F.sub(prefix[-1:], prefix), zinv_pows)
        return w[: ln - 1], prefix[-1:]

    def _quotient(self, polys, bet, gam, ks_row, al, b10, b11):
        """t = (gate + alpha perm + alpha^2 start) / v_H on the 4n coset,
        split in three at n and 2n and stitched with b10, b11."""
        n, log4, dev = self.n, self.log4, self.device
        a_poly, b_poly, c_poly, z_poly, pi_poly = polys
        a4, b4, c4, z4 = (self._cos_counted(p) for p in (a_poly, b_poly,
                                                          c_poly, z_poly))
        zs4 = torch.roll(z4, -4, 0)          # z(omega X): omega = w4^4
        ql4, qr4, qo4, qm4, qc4 = self.sel_cos
        pi4 = self._cos_counted(pi_poly)
        gate4 = F.add(
            F.add(F.mul(F.mul(a4, b4), qm4),
                  F.add(F.mul(a4, ql4), F.mul(b4, qr4))),
            F.add(F.mul(c4, qo4), F.add(pi4, qc4)))

        def lin4(p4, mult):
            return F.add(F.add(p4, F.mul(F.mul(bet, mult), self.x_cos)), gam)

        def lin4s(p4, s4):
            return F.add(F.add(p4, F.mul(bet, s4)), gam)

        perm1 = F.mul(F.mul(F.mul(lin4(a4, ks_row[0]), lin4(b4, ks_row[1])),
                            lin4(c4, ks_row[2])), z4)
        perm2 = F.mul(F.mul(F.mul(lin4s(a4, self.sig_cos[0]),
                                  lin4s(b4, self.sig_cos[1])),
                            lin4s(c4, self.sig_cos[2])), zs4)
        start4 = F.mul(F.sub(z4, F.const("one", dev)), self.l1_cos)
        numer = F.add(gate4, F.add(F.mul(al, F.sub(perm1, perm2)),
                                   F.mul(F.mul(al, al), start4)))
        t_vals = F.mul(numer, self.vh_inv_cos)
        # t has degree 3n + 5: the rows beyond 3n + 6 are structurally zero
        spans.count("coset_ntts", 1)
        t_full = P.intt_coset(log4, t_vals, self.g_cos)[: 3 * n + 6]
        t_lo = torch.cat([t_full[:n], b10])
        t_mid = torch.cat([F.sub(t_full[n:n + 1], b10), t_full[n + 1:2 * n],
                           b11])
        t_hi = torch.cat([F.sub(t_full[2 * n:2 * n + 1], b11),
                          t_full[2 * n + 1:]])
        return t_lo, t_mid, t_hi

    # -- main ------------------------------------------------------------------------

    def prove(self, assignment, public_values: Sequence[int], circuit,
              rng: Optional[_random.Random] = None, zk: bool = True
              ) -> PlonkProof:
        """A proof of `assignment` (var id -> value, or a function of no
        arguments that gives it, called inside the witness span); with
        `utils.spans` on, a `witness.fill` span (the assignment, the gate
        check `wire_arrays` and the columns' upload) and then a `prove`
        span tiled by its five `round.*` spans."""
        with spans.span("witness.fill", rows=1):
            if callable(assignment):
                assignment = assignment()
            wires = [field_rows(col, self.device) for col in
                     circuit.wire_arrays(assignment, public_values)]
        with spans.span("prove", engine="mxu", n=self.n), \
                spans.rounds(self.device) as round_:
            return self._prove(wires, public_values,
                               rng or _random.Random(), zk, round_)

    def _prove(self, wires, public_values, rng, zk, round_) -> PlonkProof:
        pk, dev = self.pk, self.device
        n, log_n, log4 = self.n, self.log_n, self.log4
        _k1, k2_, k3_ = self.ks
        round_("r1_wires")
        scalar = lambda v: _scalar(v, dev)

        wa_e, wb_e, wc_e = wires
        pi_e = P.zeros(n, dev)
        if public_values:
            pi_e[: len(public_values)] = F.neg(field_rows(public_values, dev))
        pi_poly = P.intt(log_n, pi_e)

        # ---- round 1: blinded wires ----------------------------------------------
        wire_blinds = _blinding(rng, 6, zk)

        def blind(evals, bl):
            return P.add(P.intt(log_n, evals), _mul_zh(bl, n, dev))

        a_poly = blind(wa_e, wire_blinds[0:2])
        b_poly = blind(wb_e, wire_blinds[2:4])
        c_poly = blind(wc_e, wire_blinds[4:6])
        t = _transcript(pk.vk, public_values)
        comm_a, comm_b, comm_c = self._commit_batch((a_poly, b_poly, c_poly))
        for lbl, cc in ((b"a", comm_a), (b"b", comm_b), (b"c", comm_c)):
            t.absorb_g1(lbl, cc.point)
        beta = t.challenge_fr(b"beta")
        gamma = t.challenge_fr(b"gamma")
        round_("r2_grand_product")

        # ---- round 2: grand product --------------------------------------------
        bet, gam = scalar(beta), scalar(gamma)
        ks_row = [scalar(k) for k in (1, k2_, k3_)]
        om = self.omega_pows

        def lin(we, mult):
            return F.add(F.add(we, F.mul(F.mul(bet, mult), om)), gam)

        def lin_s(we, se):
            return F.add(F.add(we, F.mul(bet, se)), gam)

        with spans.span("plonk.grand_product", n=n):
            num = F.mul(F.mul(lin(wa_e, ks_row[0]), lin(wb_e, ks_row[1])),
                        lin(wc_e, ks_row[2]))
            den = F.mul(F.mul(lin_s(wa_e, self.sig_evals[0]),
                              lin_s(wb_e, self.sig_evals[1])),
                        lin_s(wc_e, self.sig_evals[2]))
            acc = F.prefix_mul(F.mul(num, F.batch_inv(den)))
            z_evals = torch.cat([F.const("one", dev), acc[: n - 1]])
        z_poly = P.add(P.intt(log_n, z_evals),
                       _mul_zh(_blinding(rng, 3, zk), n, dev))
        (comm_z,) = self._commit_batch((z_poly,))
        t.absorb_g1(b"z", comm_z.point)
        alpha = t.challenge_fr(b"alpha")
        round_("r3_quotient")

        # ---- round 3: quotient on the 4n coset ---------------------------------
        b10, b11 = (scalar(b) for b in _blinding(rng, 2, zk))
        with spans.span("plonk.quotient", n=1 << log4):
            t_lo, t_mid, t_hi = self._quotient(
                (a_poly, b_poly, c_poly, z_poly, pi_poly), bet, gam,
                ks_row, scalar(alpha), b10, b11)
        comm_t = self._commit_batch((t_lo, t_mid, t_hi))
        for cc in comm_t:
            t.absorb_g1(b"t", cc.point)
        zeta = t.challenge_fr(b"zeta")
        round_("r4_evals")

        # ---- round 4: evaluations ------------------------------------------------
        zeta_omega = zeta * self.omega % R_MOD
        rows = self._evaluate(
            [(p, zeta) for p in (a_poly, b_poly, c_poly, self.sig_polys[0],
                                 self.sig_polys[1], self.l1_poly, pi_poly)]
            + [(z_poly, zeta_omega)], dev)
        (ev_a, ev_b, ev_c, ev_s1, ev_s2, l1_zeta, pi_zeta,
         ev_zw) = F.to_ints(rows)
        for lbl, e in ((b"a", ev_a), (b"b", ev_b), (b"c", ev_c),
                       (b"s1", ev_s1), (b"s2", ev_s2), (b"zw", ev_zw)):
            t.absorb_fr(lbl, e)
        v = t.challenge_fr(b"v")
        round_("r5_open")

        # ---- round 5: linearization and openings ---------------------------
        zh_zeta = (pow(zeta, n, R_MOD) - 1) % R_MOD
        ql, qr, qo, qm, qc = self.sel_polys
        z_coeff = (alpha
                   * ((ev_a + beta * zeta + gamma) % R_MOD)
                   * ((ev_b + beta * k2_ * zeta + gamma) % R_MOD)
                   * ((ev_c + beta * k3_ * zeta + gamma) % R_MOD)
                   + alpha * alpha % R_MOD * l1_zeta) % R_MOD
        s3_coeff = (-(alpha * beta % R_MOD * ev_zw % R_MOD
                      * ((ev_a + beta * ev_s1 + gamma) % R_MOD)
                      * ((ev_b + beta * ev_s2 + gamma) % R_MOD))) % R_MOD
        r_poly = P.add(
            P.add(
                P.add(P.scale(qm, scalar(ev_a * ev_b)),
                      P.add(P.scale(ql, scalar(ev_a)),
                            P.scale(qr, scalar(ev_b)))),
                P.add(P.scale(qo, scalar(ev_c)), qc)),
            P.add(P.scale(z_poly, scalar(z_coeff)),
                  P.scale(self.sig_polys[2], scalar(s3_coeff))))
        zn = pow(zeta, n, R_MOD)
        t_comb = P.add(P.add(t_lo, P.scale(t_mid, scalar(zn))),
                       P.scale(t_hi, scalar(zn * zn)))
        r_poly = P.sub(r_poly, P.scale(t_comb, scalar(zh_zeta)))
        r0 = (pi_zeta
              - l1_zeta * alpha * alpha
              - alpha * ((ev_a + beta * ev_s1 + gamma) % R_MOD)
              * ((ev_b + beta * ev_s2 + gamma) % R_MOD)
              * ((ev_c + gamma) % R_MOD) * ev_zw) % R_MOD
        comb = P.add(r_poly, scalar(r0))
        vp = 1
        for p, e in ((a_poly, ev_a), (b_poly, ev_b), (c_poly, ev_c),
                     (self.sig_polys[0], ev_s1), (self.sig_polys[1], ev_s2)):
            vp = vp * v % R_MOD
            comb = P.add(comb, P.scale(P.sub(p, scalar(e)), scalar(vp)))
        w_zeta_poly, comb_zeta = self._div_linear(comb, zeta)
        w_zw_poly, _ = self._div_linear(P.sub(z_poly, scalar(ev_zw)),
                                        zeta_omega)
        w_zeta, w_zeta_omega = self._commit_batch((w_zeta_poly, w_zw_poly))
        # read after the commitments, so that the card is not drained
        # before their MSMs are queued
        require(F.to_ints(comb_zeta)[0] == 0, ProofError,
                "device linearization self-check failed")
        return PlonkProof(
            comm_a=comm_a, comm_b=comm_b, comm_c=comm_c, comm_z=comm_z,
            comm_t=comm_t, eval_a=ev_a, eval_b=ev_b, eval_c=ev_c,
            eval_s1=ev_s1, eval_s2=ev_s2, eval_zw=ev_zw,
            w_zeta=w_zeta, w_zeta_omega=w_zeta_omega,
        )
