"""Marlin prover on device — counterpart of marlin/prover_jax.JaxProver.

Round for round the same protocol as the host prover marlin/prover.py and
the JAX prover: every polynomial, NTT, batch inversion and MSM runs on limb
tensors of one device; the host sees only commitments (for the Fiat-Shamir
transcript, absorbed in the reference's exact order), challenges and the
proof object. With zk=False the proof equals the host prover's field for
field; with a seeded rng a zk proof equals JaxProver's, because the masking
randomness is drawn exactly as prover_jax draws it.

Fr products run kernel K1 and transforms K2. Every commitment and both
opening proofs run on one of the JAX prover's two MSM engines, chosen by
`msm_engine`: "mxu" (the default) is the signed 13-bit Pippenger of
ops/msm.py (kernel K3, the counterpart of msm_mxu), "pallas" the 8-bit
bucket scan of ops/msm_device.py (kernel K4, the counterpart of
msm_device). Left unset, ZKAES_MSM_MXU=0 selects "pallas", as it does in
prover_jax. Each MSM leaves its point on the device; a batch of commitments
comes to the host in one copy. The hiding terms stay on the host (two gamma
powers a commitment, eight an opening), in the same order as in the
reference: computed in native code outside the interpreter lock
(kzg.hiding_terms) after the batch's MSMs are enqueued and before their
points are read back, so the card runs the MSMs meanwhile.

With a `mesh` (parallel/mesh.py), as JaxProver(mesh=...): the six
transforms on the 4n domain run as the four-step sharded NTT and every MSM
shards its points over the mesh, each device on its own replica of the
SRS; the rest runs on the mesh's first device. Both are exact, so a mesh
proof equals the single-device proof from the same rng byte for byte.
"""

from __future__ import annotations

import os
import random as _random
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np
import torch

from ..ops import kzg
from ..ops import poly as P
from ..ops.field import fr_ops
from ..ops.field_params import R_MOD, fr_multiplicative_generator
from ..ops import msm_pallas
from ..ops.msm import (
    GROUP_BYTES,
    PAIR_BYTES,
    msm_point,
    n_windows,
    window_bits,
    window_groups,
    xyzz_to_affine,
)
from ..ops.msm_device import DevicePoints, digit_limbs, msm_device_point
from ..ops.poly_host import domain, poly_div_linear
from ..parallel.mesh import Mesh, replicated
from ..parallel.sharded_msm import msm_sharded
from ..parallel.sharded_ntt import four_step_split, ntt_sharded
from ..utils import spans
from ..utils.device import resolve_device
from ..utils.srs import device_powers
from ..utils.transcript import Transcript

if TYPE_CHECKING:
    from .indexer import MarlinProvingKey

F = fr_ops()
L = F.L
RAND_BYTES = 34   # prover_jax._rand_mont draws one 34-byte value per element
# bytes one randbytes call draws: it takes fewer than 2^31 bits, and whole
# 32-bit words, so that the chunks join into the bytes of one call
RAND_CHUNK = 1 << 27

# device bytes a prove holds a row of H besides its MSM's window group: the
# proof's polynomials, its 4n-domain and coset temporaries and, on a cold
# key, the twiddle and coset-power tables it caches (72 Fr rows; a 1 KB
# prove's, reckoned at n = 2^24: 18 GiB of polynomials, 8.3 of round-3
# cosets, 6.5 of tables, 2,100 B a row). chip_smoke.py holds the peak of a
# warm 16-byte, 64-byte and 1 KB prove on an H100 under `proof_bytes`.
PROOF_ROW_BYTES = 72 * 32

MSM_ENGINES = ("mxu", "pallas")


@dataclass
class MarlinProof:
    """Self-describing proof object (serializable via utils/serialize.py).

    Reference analog: simpleworks::marlin::MarlinProof (SURVEY.md §2b).
    """

    # round commitments
    comm_w: kzg.Commitment
    comm_za: kzg.Commitment
    comm_zb: kzg.Commitment
    comm_s: kzg.Commitment
    comm_t: kzg.Commitment
    comm_g1: kzg.Commitment
    comm_g1_shift: kzg.Commitment
    comm_h1: kzg.Commitment
    comm_g2: List[kzg.Commitment]        # per matrix
    comm_g2_shift: List[kzg.Commitment]  # per matrix
    comm_h2: List[kzg.Commitment]        # per matrix
    sigmas: List[int]                    # per matrix inner-sumcheck sums
    # evaluations at beta1 (H side): w, za, zb, s, t, g1, h1
    evals_beta1: List[int]
    # evaluations at beta2 (K side), per matrix: row, col, val, g2, h2
    evals_beta2: List[List[int]]
    # batched opening proofs
    open_beta1: kzg.OpeningProof
    open_beta2: kzg.OpeningProof


def default_msm_engine() -> str:
    """The engine prover_jax._mxu_ok picks: "pallas" when ZKAES_MSM_MXU is
    "0", "mxu" otherwise."""
    return "pallas" if os.environ.get("ZKAES_MSM_MXU", "1") == "0" else "mxu"


def proof_bytes(log_n: int, max_degree: int, msm_engine: str = "mxu") -> int:
    """Device bytes one prove holds above its key and prover, reckoned:
    PROOF_ROW_BYTES a row of H, and the first window group of its largest
    MSM, the opening over all max_degree + 1 SRS points, on `msm_engine`."""
    points = max_degree + 1
    if msm_engine == "pallas":
        windows, pair = msm_pallas.WINDOWS, msm_pallas.PAIR_BYTES
    else:
        windows, pair = n_windows(window_bits(points)), PAIR_BYTES
    w0, w1 = window_groups(windows, points, pair, GROUP_BYTES)[0]
    return (PROOF_ROW_BYTES << log_n) + (w1 - w0) * points * pair


def to_msm_digits(coeffs_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery coefficients -> standard-form limbs (the MSM scalars)."""
    return F.to_canonical_limbs(coeffs_mont)


def _small_to_mont(vals: torch.Tensor) -> torch.Tensor:
    """[N] signed integers -> Montgomery rows."""
    return F.from_small(vals)


def _sparse_ints(positions: Sequence[int], values: Sequence[int],
                 length: int, device) -> torch.Tensor:
    """Host sparse int poly -> dense device dpoly."""
    out = P.zeros(length, device)
    with spans.wait("sparse_positions", upload=8 * len(positions)):
        where = torch.as_tensor(list(positions), device=device)
    out[where] = F.from_ints(values, device)
    return out


def _rand_mont(rng: _random.Random, n: int, device) -> torch.Tensor:
    """n uniform field elements: each a 34-byte little-endian draw reduced
    mod r (the draw of prover_jax._rand_mont), as V_lo R + V_hi R^2. The
    bytes come in chunks of RAND_CHUNK (one call cannot draw the 2^25 + 1
    elements of a 1 KB proof's mask), equal to one call's bytes."""
    with spans.span("host.mask_draw", elements=n):
        total = n * RAND_BYTES
        raw = np.frombuffer(b"".join(
            rng.randbytes(min(RAND_CHUNK, total - i))
            for i in range(0, total, RAND_CHUNK)), np.uint8)
        raw = raw.reshape(n, RAND_BYTES)
        lo = np.ascontiguousarray(raw[:, :32]).view("<u4").view(np.int32)
        hi = np.zeros((n, L), np.int32)
        hi[:, 0] = (raw[:, 32].astype(np.int32)
                    | (raw[:, 33].astype(np.int32) << 8))
        with spans.wait("mask_limbs", upload=lo.nbytes + hi.nbytes):
            lo_t = torch.from_numpy(lo.copy()).to(device)
            hi_t = torch.from_numpy(hi).to(device)
        return F.add(F.mul(lo_t, F.const("r2", device)),
                     F.mul(hi_t, F.const("r3", device)))


def _signed(vals) -> np.ndarray:
    """Matrix values as signed int64: np arrays (device indexers) already
    are; host-indexer lists hold field elements."""
    if isinstance(vals, np.ndarray):
        return vals.astype(np.int64)
    return np.asarray([v if v < R_MOD // 2 else v - R_MOD for v in vals],
                      np.int64)


def coo_arrays(r1cs):
    """(row, column, signed value) int arrays of A, B and C."""
    out = []
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        ri, ci, vi = [], [], []
        for i, row in enumerate(rows):
            for c, v in sorted(row.items()):
                ri.append(i)
                ci.append(c)
                vi.append(v if v < R_MOD // 2 else v - R_MOD)
        out.append((np.asarray(ri, np.int64), np.asarray(ci, np.int64),
                    np.asarray(vi, np.int64)))
    return out


class TorchProver:
    """Device-resident prover bound to one proving key and one device, or
    to a mesh (its first device holds the prover's state; `device`, if
    given, must be that device).

    Threads may prove on one prover at once, each on its own CUDA stream
    (`api.encrypt_batch`): a prove keeps its buffers to itself and the
    prover keeps none between calls. With `utils.spans` on, a prove is a
    `prove` span tiled by its eight `round.*` spans."""

    def __init__(self, pk: MarlinProvingKey, device=None,
                 msm_engine: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.pk = pk
        if mesh is None:
            self.device = resolve_device(device or "cuda")
        elif not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                             f"{type(mesh).__name__}")
        elif device is not None and Mesh((device,)).first != mesh.first:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.first}")
        else:
            self.device = mesh.first
        self.mesh = mesh
        self.msm_engine = msm_engine or default_msm_engine()
        if self.msm_engine not in MSM_ENGINES:
            raise ValueError(f"msm_engine must be one of {MSM_ENGINES}, got "
                             f"{self.msm_engine!r}")
        dev = self.device
        self.n = pk.n
        self.log_n = pk.log_n
        self.x_size = pk.x_size
        self.d_max = pk.srs.max_degree
        points = getattr(pk, "torch_points", None)
        if points is None or points.device != dev:
            points = device_powers(pk.srs, dev)
        self.srs_dev = DevicePoints(points)
        self.hiding_bases = kzg.HidingBases(pk.srs.gamma_powers_g1)
        # the SRS on every mesh device, placed once (shards on one card
        # share its copy)
        self.srs_shards = None if mesh is None else [
            DevicePoints(p) for p in replicated(mesh, points)]

        coo = getattr(pk, "coo_np", None) or coo_arrays(pk.r1cs)
        self.coo = [tuple(torch.as_tensor(np.asarray(a, np.int64), device=dev)
                          for a in m) for m in coo]
        self.var_to_slot = torch.as_tensor(
            np.asarray(pk.var_to_slot, np.int64), device=dev)

        h = domain(self.log_n)
        self.h_pows = P.powers(P.scalar(h.omega, dev), self.n)
        self.n_inv_s = P.scalar(pow(self.n, -1, R_MOD), dev)
        self.mat = []
        for m in pk.matrices:
            row_slots = torch.as_tensor(np.asarray(m.row_slots, np.int64),
                                        device=dev)
            col_slots = torch.as_tensor(np.asarray(m.col_slots, np.int64),
                                        device=dev)
            vals = torch.as_tensor(_signed(m.vals), device=dev)
            row_evals = self.h_pows[row_slots]
            col_evals = self.h_pows[col_slots]
            val_norm = F.mul(F.mul(_small_to_mont(vals), col_evals),
                             self.n_inv_s)
            self.mat.append(dict(
                log_k=m.log_k, k=m.k, row_slots=row_slots,
                col_slots=col_slots, vals=vals,
                row_coeffs=P.intt(m.log_k, row_evals),
                col_coeffs=P.intt(m.log_k, col_evals),
                val_coeffs=P.intt(m.log_k, val_norm)))

        h4 = domain(self.log_n + 2)
        self.h4_pows = P.powers(P.scalar(h4.omega, dev), h4.n)
        wn4 = pow(h4.omega, self.n, R_MOD)
        cyc = [(pow(wn4, i, R_MOD) - 1) % R_MOD for i in range(4)]
        self.vh_on_h4 = F.from_ints(cyc, dev).repeat(h4.n // 4, 1)

    # -- the 4n domain's transforms (four-step over the mesh, if any) -----------

    def _ntt4(self, coeffs: torch.Tensor) -> torch.Tensor:
        log_n4 = self.log_n + 2
        if self.mesh is None:
            return P.ntt_to(log_n4, coeffs)
        return ntt_sharded(self.mesh, P.pad_to(coeffs, 1 << log_n4),
                           *four_step_split(log_n4, self.mesh.size))

    def _intt4(self, evals: torch.Tensor) -> torch.Tensor:
        log_n4 = self.log_n + 2
        if self.mesh is None:
            return P.intt(log_n4, evals)
        return ntt_sharded(self.mesh, evals,
                           *four_step_split(log_n4, self.mesh.size),
                           inverse=True)

    # -- commitments -------------------------------------------------------------

    def _msm(self, offset: int, coeffs: torch.Tensor) -> torch.Tensor:
        """The commitment MSM as one XYZZ point [4, 12] on the device
        (sharded over the mesh, as prover_jax._msm_dev, when there is one)."""
        with spans.span("msm", points=coeffs.shape[0],
                        engine=self.msm_engine):
            return self._msm_point(offset, coeffs)

    def _msm_point(self, offset: int, coeffs: torch.Tensor) -> torch.Tensor:
        scalars = to_msm_digits(coeffs)
        if self.mesh is not None:
            return msm_sharded(
                self.mesh, [s.slice(offset, coeffs.shape[0])
                            for s in self.srs_shards], scalars,
                self.msm_engine)
        points = self.srs_dev.slice(offset, coeffs.shape[0])
        if self.msm_engine == "pallas":
            return msm_device_point(points, digit_limbs(scalars))
        return msm_point(points, scalars)

    def _commit_batch(self, items, rng: Optional[_random.Random] = None):
        """items: (coeffs, offset, hiding). Hiding randomness is drawn first,
        in item order, as prover_jax._commit_batch draws it. Every MSM of the
        batch is enqueued, then the hiding terms are computed on the host
        while the card runs them, then their points come to the host in one
        copy."""
        rand_list = [
            [rng.randrange(R_MOD) for _ in range(2)] if hid else None
            for (_c, _off, hid) in items
        ]
        stacked = torch.stack(
            [self._msm(off, coeffs) for coeffs, off, _hid in items])
        hiding = [i for i, r in enumerate(rand_list) if r is not None]
        terms = []
        if hiding:
            with spans.span("host.hiding", points=2 * len(hiding)):
                terms = kzg.hiding_terms(self.hiding_bases,
                                         [rand_list[i] for i in hiding])
        points = xyzz_to_affine(stacked)
        for i, term in zip(hiding, terms):
            points[i] = points[i].add(term)
        return [(kzg.Commitment(pt), rand_poly)
                for pt, rand_poly in zip(points, rand_list)]

    # -- main ----------------------------------------------------------------------

    def prove(self, instance: Sequence[int], witness_bits,
              rng: Optional[_random.Random] = None, zk: bool = True
              ) -> MarlinProof:
        """instance: [1] + public field elements; witness_bits: the witness
        values (array or tensor of small integers)."""
        if len(instance) != self.pk.r1cs.num_instance or instance[0] != 1:
            raise ValueError("instance must be [1] + the public inputs")
        with spans.span("prove", engine=self.msm_engine, n=self.n), \
                spans.rounds(self.device) as round_:
            return self._prove(instance, witness_bits, rng or _random.Random(),
                               zk, round_)

    def _prove(self, instance, witness_bits, rng: _random.Random, zk: bool,
               round_) -> MarlinProof:
        pk, dev = self.pk, self.device
        n, log_n, x_size, d_max = self.n, self.log_n, self.x_size, self.d_max
        round_("r1_polys")
        t = Transcript()
        with spans.span("host.transcript"):
            pk.vk.absorb_into(t)
            t.absorb_fr_list(b"instance", instance)

        with spans.wait("instance", upload=8 * len(instance)):
            inst = torch.as_tensor(np.asarray(instance, np.int64), device=dev)
        z = torch.cat([
            inst, torch.as_tensor(witness_bits, device=dev).to(torch.int64)])

        # ---- round 1 ---------------------------------------------------------
        za_list = []
        for (ri, ci, vi) in self.coo[:2]:
            vals = torch.zeros(n, dtype=torch.int64, device=dev)
            vals.index_add_(0, ri, vi * z[ci])
            za_list.append(_small_to_mont(vals))
        za_coeffs = P.intt(log_n, za_list[0])
        zb_coeffs = P.intt(log_n, za_list[1])

        z_slots = torch.zeros(n, dtype=torch.int64, device=dev)
        z_slots[self.var_to_slot] = z
        xd = domain(pk.log_x)
        x_poly = P.dpoly(
            xd.intt(list(instance) + [0] * (x_size - len(instance))), dev)
        x_on_h = P.ntt_to(log_n, x_poly)
        w_full = P.intt(log_n, F.sub(_small_to_mont(z_slots), x_on_h))
        w_hat, _w_rem = P.div_vanishing(w_full, x_size)
        round_("r1_commits")

        if zk:
            with spans.span("host.mask_draw", elements=6):
                r_w = [rng.randrange(R_MOD) for _ in range(2)]
                r_a = [rng.randrange(R_MOD) for _ in range(2)]
                r_b = [rng.randrange(R_MOD) for _ in range(2)]
            ratio_pos, ratio_val = [], []
            for j in range(n // x_size):
                ratio_pos += [j * x_size, j * x_size + 1]
                ratio_val += [r_w[0], r_w[1]]
            w_hat = P.add(w_hat, _sparse_ints(ratio_pos, ratio_val,
                                              n - x_size + 2, dev))

            def vh_mult(rr):
                return _sparse_ints([0, 1, n, n + 1],
                                    [-rr[0], -rr[1], rr[0], rr[1]], n + 2, dev)

            za_coeffs = P.add(za_coeffs, vh_mult(r_a))
            zb_coeffs = P.add(zb_coeffs, vh_mult(r_b))
            s_coeffs = _rand_mont(rng, 2 * n + 1, dev)
            s_coeffs[0:1] = F.neg(F.add(s_coeffs[n:n + 1],
                                        s_coeffs[2 * n:2 * n + 1]))
        else:
            s_coeffs = P.zeros(1, dev)

        hb = zk
        ((comm_w, rand_w), (comm_za, rand_za), (comm_zb, rand_zb),
         (comm_s, rand_s)) = self._commit_batch(
            [(w_hat, 0, hb), (za_coeffs, 0, hb), (zb_coeffs, 0, hb),
             (s_coeffs, 0, hb)], rng=rng)
        with spans.span("host.transcript"):
            for lbl, c in ((b"w", comm_w), (b"za", comm_za),
                           (b"zb", comm_zb), (b"s", comm_s)):
                t.absorb_g1(lbl, c.point)
            alpha = t.challenge_fr(b"alpha")
            eta_a = t.challenge_fr(b"eta_a")
            eta_b = t.challenge_fr(b"eta_b")
            eta_c = t.challenge_fr(b"eta_c")

        # ---- round 2 ---------------------------------------------------------
        round_("r2_polys")
        h = domain(log_n)
        v_h_alpha = h.vanishing_eval(alpha)
        alpha_s = P.scalar(alpha, dev)
        contribs, slots = [], []
        for eta, md in zip((eta_a, eta_b, eta_c), self.mat):
            denom_inv = F.batch_inv(F.sub(alpha_s, self.h_pows[md["row_slots"]]))
            contribs.append(F.mul(
                F.mul(_small_to_mont(md["vals"]), denom_inv),
                P.scalar(eta * v_h_alpha % R_MOD, dev)))
            slots.append(md["col_slots"])
        t_vals = P.segment_sum_mod(torch.cat(contribs), torch.cat(slots), n)
        t_coeffs = P.intt(log_n, t_vals)
        del contribs, slots, t_vals

        w_vx = P.sub(torch.cat([P.zeros(x_size, dev), w_hat]), w_hat)
        z_coeffs = P.add(w_vx, x_poly)

        denom4 = F.batch_inv(F.sub(alpha_s, self.h4_pows))
        r4 = F.mul(F.sub(P.scalar(v_h_alpha, dev), self.vh_on_h4), denom4)
        ea, eb, ec = (P.scalar(v, dev) for v in (eta_a, eta_b, eta_c))
        za4 = self._ntt4(za_coeffs)
        zb4 = self._ntt4(zb_coeffs)
        p4 = F.add(F.add(F.mul(ea, za4), F.mul(eb, zb4)),
                   F.mul(ec, F.mul(za4, zb4)))
        q_acc = F.add(self._ntt4(s_coeffs), F.mul(r4, p4))
        tz4 = F.mul(self._ntt4(t_coeffs), self._ntt4(z_coeffs))
        q1 = self._intt4(F.sub(q_acc, tz4))
        # the 4n-row temporaries go before the commits (2 GiB each at n =
        # 2^24)
        del denom4, r4, za4, zb4, p4, q_acc, tz4, w_vx, z_coeffs
        h1_coeffs, rem = P.div_vanishing(q1, n)
        del q1
        # deg h1 <= 2n + 1: the rows beyond are structurally zero (a copy,
        # so that the 4n-row quotient buffer goes)
        h1_coeffs = h1_coeffs[: min(h1_coeffs.shape[0], 2 * n + 2)].clone()
        g1_coeffs = rem[1:]
        g1_shift = d_max - (n - 2)
        round_("r2_commits")

        ((comm_t, _), (comm_g1, rand_g1), (comm_g1s, rand_g1s),
         (comm_h1, rand_h1)) = self._commit_batch(
            [(t_coeffs, 0, False), (g1_coeffs, 0, hb),
             (g1_coeffs, g1_shift, hb), (h1_coeffs, 0, hb)], rng=rng)
        with spans.span("host.transcript"):
            for lbl, c in ((b"t", comm_t), (b"g1", comm_g1),
                           (b"g1s", comm_g1s), (b"h1", comm_h1)):
                t.absorb_g1(lbl, c.point)
            beta1 = t.challenge_fr(b"beta1")

        # ---- round 3 ---------------------------------------------------------
        round_("r3_polys_commits")
        v_h_beta1 = h.vanishing_eval(beta1)
        scale_int = v_h_alpha * v_h_beta1 % R_MOD
        scale_s = P.scalar(scale_int, dev)
        beta1_s = P.scalar(beta1, dev)
        g_cos = fr_multiplicative_generator()
        g2_list, h2_list, g2_shifts, sigmas = [], [], [], []
        comm_g2, comm_g2s, comm_h2 = [], [], []
        for md in self.mat:
            k, log_k = md["k"], md["log_k"]
            row_evals = self.h_pows[md["row_slots"]]
            col_evals = self.h_pows[md["col_slots"]]
            val_norm = F.mul(F.mul(_small_to_mont(md["vals"]), col_evals),
                             self.n_inv_s)
            b_vals = F.mul(F.sub(alpha_s, row_evals),
                           F.sub(beta1_s, col_evals))
            f_vals = F.mul(F.mul(val_norm, scale_s), F.batch_inv(b_vals))
            sigmas.append(F.to_ints(P.tree_sum(f_vals))[0])
            f_coeffs = P.intt(log_k, f_vals)
            g2 = f_coeffs[1:]
            a_coeffs = P.scale(md["val_coeffs"], scale_s)
            # h2 = (a - b f) / v_K on the coset g*K2 (2k points): deg h2 =
            # 2k - 3 < 2k, so the coset interpolation is exact
            log_k2 = log_k + 1
            u2 = F.sub(alpha_s, P.ntt_coset(log_k2, md["row_coeffs"], g_cos))
            v2 = F.sub(beta1_s, P.ntt_coset(log_k2, md["col_coeffs"], g_cos))
            bf2 = F.mul(F.mul(u2, v2), P.ntt_coset(log_k2, f_coeffs, g_cos))
            a2 = P.ntt_coset(log_k2, a_coeffs, g_cos)
            # v_K(g w2^j) = g^k (-1)^j - 1  (w2^k = -1), alternating in j
            gk = pow(g_cos, k, R_MOD)
            vk_inv = F.from_ints([pow(gk - 1, -1, R_MOD),
                                  pow((R_MOD - gk - 1) % R_MOD, -1, R_MOD)],
                                 dev).repeat(k, 1)
            h2 = P.intt_coset(log_k2, F.mul(F.sub(a2, bf2), vk_inv),
                              g_cos)[: 2 * k - 2]
            # only g2 and h2 outlive the matrix: its cosets (2k rows each)
            # go before the next one's are made
            del (row_evals, col_evals, val_norm, b_vals, f_vals, f_coeffs,
                 a_coeffs, u2, v2, bf2, a2, vk_inv)
            g2_shifts.append(d_max - (k - 2))
            g2_list.append(g2)
            h2_list.append(h2)
        commit_items = []
        for g2, h2, shift in zip(g2_list, h2_list, g2_shifts):
            commit_items += [(g2, 0, False), (g2, shift, False),
                             (h2, 0, False)]
        flat = self._commit_batch(commit_items)
        with spans.span("host.transcript"):
            for i, sigma in enumerate(sigmas):
                (cg2, _), (cg2s, _), (ch2, _) = flat[3 * i: 3 * i + 3]
                comm_g2.append(cg2)
                comm_g2s.append(cg2s)
                comm_h2.append(ch2)
                t.absorb_fr(b"sigma", sigma)
                t.absorb_g1(b"g2", cg2.point)
                t.absorb_g1(b"g2s", cg2s.point)
                t.absorb_g1(b"h2", ch2.point)
            beta2 = t.challenge_fr(b"beta2")

        # ---- evaluations -----------------------------------------------------
        round_("evals")
        b1_polys = (w_hat, za_coeffs, zb_coeffs, s_coeffs, t_coeffs,
                    g1_coeffs, h1_coeffs)
        b2_polys = []
        for md, g2, h2 in zip(self.mat, g2_list, h2_list):
            b2_polys += [md["row_coeffs"], md["col_coeffs"], md["val_coeffs"],
                         g2, h2]
        rows1 = self._eval_many(b1_polys, P.scalar(beta1, dev))
        rows2 = self._eval_many(b2_polys, P.scalar(beta2, dev))
        all_ints = F.to_ints(torch.cat([rows1, rows2]))
        evals_beta1 = all_ints[:7]
        evals_beta2 = [all_ints[7 + 5 * i: 12 + 5 * i] for i in range(3)]
        with spans.span("host.transcript"):
            t.absorb_fr_list(b"evals_beta1", evals_beta1)
            for e in evals_beta2:
                t.absorb_fr_list(b"evals_beta2", e)
            xi1 = t.challenge_fr(b"xi1")
            xi2 = t.challenge_fr(b"xi2")

        round_("open_beta1")
        open_beta1 = self._batch_open(
            [(w_hat, 0, rand_w), (za_coeffs, 0, rand_za),
             (zb_coeffs, 0, rand_zb), (s_coeffs, 0, rand_s),
             (t_coeffs, 0, None), (g1_coeffs, 0, rand_g1),
             (g1_coeffs, g1_shift, rand_g1s), (h1_coeffs, 0, rand_h1)],
            beta1, xi1)
        round_("open_beta2")
        beta2_polys = []
        for md, g2, h2, shift in zip(self.mat, g2_list, h2_list, g2_shifts):
            beta2_polys += [(md["row_coeffs"], 0, None),
                            (md["col_coeffs"], 0, None),
                            (md["val_coeffs"], 0, None), (g2, 0, None),
                            (g2, shift, None), (h2, 0, None)]
        open_beta2 = self._batch_open(beta2_polys, beta2, xi2)

        return MarlinProof(
            comm_w=comm_w, comm_za=comm_za, comm_zb=comm_zb, comm_s=comm_s,
            comm_t=comm_t, comm_g1=comm_g1, comm_g1_shift=comm_g1s,
            comm_h1=comm_h1, comm_g2=comm_g2, comm_g2_shift=comm_g2s,
            comm_h2=comm_h2, sigmas=sigmas, evals_beta1=evals_beta1,
            evals_beta2=evals_beta2, open_beta1=open_beta1,
            open_beta2=open_beta2,
        )

    # -- evaluations and openings -------------------------------------------------

    @staticmethod
    def _eval_many(polys, z: torch.Tensor) -> torch.Tensor:
        """[len(polys), 8] rows of p_i(z) from one shared powers table."""
        zpow = P.powers(z, max(p.shape[0] for p in polys))
        return torch.cat([P.tree_sum(F.mul(p, zpow[: p.shape[0]]))
                          for p in polys])

    @staticmethod
    def _open_quotient(polys, xi_rows: torch.Tensor, z: int,
                       max_len: int) -> torch.Tensor:
        """Coefficients of (F(X) - F(z)) / (X - z), F = sum_i xi^i X^off_i
        p_i: w_i = (F(z) - sum_{j<=i} F_j z^j) z^-(i+1)."""
        dev = xi_rows.device
        comb = P.zeros(max_len, dev)
        for i, (coeffs, off) in enumerate(polys):
            seg = slice(off, off + coeffs.shape[0])
            comb[seg] = F.add(comb[seg], F.mul(coeffs, xi_rows[i:i + 1]))
        prefix = P.prefix_sum(F.mul(comb, P.powers(P.scalar(z, dev), max_len)))
        zinv = P.scalar(pow(z, -1, R_MOD), dev)
        zinv_pows = F.mul(P.powers(zinv, max_len), zinv)
        w = F.mul(F.sub(prefix[-1:], prefix), zinv_pows)
        # the top coefficient is 0 by construction; drop it
        return w[: max_len - 1]

    def _batch_open(self, polys, z: int, xi: int) -> kzg.OpeningProof:
        max_len = max(off + p.shape[0] for p, off, _ in polys)
        xi_pows: List[int] = []
        xi_pow = 1
        for _ in polys:
            xi_pows.append(xi_pow)
            xi_pow = xi_pow * xi % R_MOD
        w_coeffs = self._open_quotient(
            [(p, off) for p, off, _r in polys],
            F.from_ints(xi_pows, self.device), z, max_len)
        w_dev = self._msm(0, w_coeffs)
        # the hiding term, on the host while the card runs the MSM
        rand_eval, terms = 0, []
        rands = [(x, r) for x, (_p, _off, r) in zip(xi_pows, polys)
                 if r is not None]
        if rands:
            with spans.span("host.hiding", points=kzg.HIDING_POWERS):
                comb_rand = [0] * (kzg.HIDING_POWERS + 1)
                for xi_pow, rand_poly in rands:
                    for i, c in enumerate(rand_poly):
                        comb_rand[i] = (comb_rand[i] + xi_pow * c) % R_MOD
                wr, rand_eval = poly_div_linear(comb_rand, z)
                terms = kzg.hiding_terms(self.hiding_bases, [wr])
        w_point = xyzz_to_affine(w_dev)[0]
        for term in terms:
            w_point = w_point.add(term)
        return kzg.OpeningProof(w=w_point, rand_eval=rand_eval)
