"""The JAX package's state in the port's layout, and back.

Tensors: JAX field elements are [N, D] float32 8-bit digits of a*R_f mod p
in a redundant band (ops/field_f32.py: Fr D = 34, R_f = 2^272; Fq D = 50,
R_f = 2^400); the port's are [N, L] u32 limbs of a*R_p mod p, fully reduced
(R_p = 2^256 / 2^384). The radixes differ, so a value moves between them by
one Montgomery product with R_p^2 / R_f (in) or R_f (out). Everything is
vectorized: no Python bigint per element.

Objects: a circuit, witness plan, SRS or proving key built by the JAX
package becomes this package's own type through `r1cs_from`, `plan_from`,
`srs_from`, `proving_key_from` and `plonk_proving_key_from`. They read
plain attributes, integers and numpy arrays only (matrices as COO arrays,
points as coordinates, SRS powers as the packed checkpoint array) and
import nothing of the JAX package, so no foreign class enters this
package.
"""

from __future__ import annotations

import numpy as np
import torch

from .marlin.indexer import MarlinProvingKey, MarlinVerifyingKey, MatrixIndex
from .models.r1cs import R1CS
from .models.witness_plan import CompiledPlan, LevelArrays
from .ops import kzg
from .ops.curve_host import g1_infinity, g1_point, g2_infinity, g2_point
from .ops.field import FieldOps, fq_ops, fr_ops
from .ops.field_host import Fq2
from .ops.field_params import R_MOD
from .ops.msm import points_from_packed
from .plonk.backend import PlonkProvingKey, PlonkVerifyingKey
from .plonk.circuit import Gate, PlonkCircuitData
from .utils.srs import PackedPowers, pack_points

FR_DIGITS = 34
FQ_DIGITS = 50

__all__ = ["fr_from_f32_digits", "fq_from_f32_digits", "fr_to_f32_digits",
           "fq_to_f32_digits", "points_from_packed", "r1cs_from", "plan_from",
           "srs_from", "proving_key_from", "plonk_proving_key_from"]


def _exact_bytes(digits: np.ndarray) -> np.ndarray:
    """Redundant digits (band ~(-2, 260), non-negative value) -> canonical
    base-256 digits [N, D] uint8 of the same integer."""
    d = np.rint(np.asarray(digits, np.float64)).astype(np.int64)
    d = d.reshape(-1, d.shape[-1])
    out = np.empty(d.shape, np.uint8)
    carry = np.zeros(d.shape[0], np.int64)
    for j in range(d.shape[1]):
        t = d[:, j] + carry
        out[:, j] = t & 0xFF
        carry = t >> 8
    if np.any(carry != 0):
        raise ValueError("digit rows do not hold non-negative values")
    return out


def _from_digits(f: FieldOps, digits: np.ndarray, r_f: int, device
                 ) -> torch.Tensor:
    by = _exact_bytes(digits)
    width = 4 * f.L
    if np.any(by[:, width:] != 0):
        raise ValueError("digit value exceeds the limb width")
    raw = np.zeros((by.shape[0], width), np.uint8)
    raw[:, : min(width, by.shape[1])] = by[:, :width]
    limbs = torch.from_numpy(raw.view("<u4").view(np.int32).copy()).to(device)
    k = f.R * f.R * pow(r_f, -1, f.modulus) % f.modulus
    return f.mul(limbs, f.from_ints([k], device, mont=False))


def _to_digits(f: FieldOps, x: torch.Tensor, r_f: int, n_digits: int
               ) -> np.ndarray:
    k = f.from_ints([r_f % f.modulus], x.device, mont=False)
    std = f.mul(x, k).cpu().numpy()
    by = np.ascontiguousarray(std).view(np.uint8).reshape(std.shape[0], -1)
    out = np.zeros((std.shape[0], n_digits), np.float32)
    out[:, : by.shape[1]] = by
    return out


def fr_from_f32_digits(digits: np.ndarray, device) -> torch.Tensor:
    return _from_digits(fr_ops(), digits, 1 << (8 * FR_DIGITS), device)


def fq_from_f32_digits(digits: np.ndarray, device) -> torch.Tensor:
    return _from_digits(fq_ops(), digits, 1 << (8 * FQ_DIGITS), device)


def fr_to_f32_digits(x: torch.Tensor) -> np.ndarray:
    return _to_digits(fr_ops(), x, 1 << (8 * FR_DIGITS), FR_DIGITS)


def fq_to_f32_digits(x: torch.Tensor) -> np.ndarray:
    return _to_digits(fq_ops(), x, 1 << (8 * FQ_DIGITS), FQ_DIGITS)


# -- objects ---------------------------------------------------------------------


def _signed(v: int) -> int:
    v = int(v) % R_MOD
    s = v if v < R_MOD // 2 else v - R_MOD
    if not -(1 << 62) <= s < (1 << 62):
        raise ValueError("matrix value does not fit a signed int64")
    return s


def _coo(rows):
    """Rows of {column: value} -> (row, column, signed value) int64 arrays."""
    ri, ci, vi = [], [], []
    for i, row in enumerate(rows):
        for c, v in sorted(row.items()):
            ri.append(i)
            ci.append(int(c))
            vi.append(_signed(v))
    return (np.asarray(ri, np.int64), np.asarray(ci, np.int64),
            np.asarray(vi, np.int64))


def _rows(ri: np.ndarray, ci: np.ndarray, vi: np.ndarray, n_rows: int):
    rows = [{} for _ in range(n_rows)]
    for r, c, v in zip(ri.tolist(), ci.tolist(), vi.tolist()):
        rows[r][c] = v % R_MOD
    return rows


def r1cs_from(cs) -> R1CS:
    """A finalized constraint system, carried as COO arrays."""
    n_rows = len(cs.a_rows)
    mats = [_coo(rows) for rows in (cs.a_rows, cs.b_rows, cs.c_rows)]
    return R1CS(num_instance=int(cs.num_instance),
                num_witness=int(cs.num_witness),
                a_rows=_rows(*mats[0], n_rows), b_rows=_rows(*mats[1], n_rows),
                c_rows=_rows(*mats[2], n_rows))


def plan_from(plan) -> CompiledPlan:
    """A compiled witness plan: its index and coefficient arrays, copied."""
    arr = lambda a: np.array(a, copy=True)
    return CompiledPlan(
        num_vars=int(plan.num_vars), num_instance=int(plan.num_instance),
        levels=[LevelArrays(out=arr(lv.out), x=arr(lv.x), y=arr(lv.y),
                            s=arr(lv.s), coeffs=arr(lv.coeffs))
                for lv in plan.levels],
        input_idx={k: arr(v) for k, v in plan.input_idx.items()},
        input_slot={k: arr(v) for k, v in plan.input_slot.items()},
        inst_idx=arr(plan.inst_idx), inst_c=arr(plan.inst_c),
        inst_var=arr(plan.inst_var), inst_q=arr(plan.inst_q))


def _g1(p):
    return g1_infinity() if p.inf else g1_point(int(p.x), int(p.y))


def _g2(p):
    if p.inf:
        return g2_infinity()
    return g2_point(Fq2(int(p.x.c0), int(p.x.c1)),
                    Fq2(int(p.y.c0), int(p.y.c1)))


def srs_from(srs) -> kzg.SRS:
    """An SRS: the G1 powers as the packed [N, 2, 24] checkpoint array."""
    return kzg.SRS(max_degree=int(srs.max_degree),
                   powers_g1=PackedPowers(np.array(pack_points(srs.powers_g1),
                                                   np.uint32, copy=True)),
                   gamma_powers_g1=[_g1(p) for p in srs.gamma_powers_g1],
                   h=_g2(srs.h), tau_h=_g2(srs.tau_h))


def _commitment(c) -> kzg.Commitment:
    return kzg.Commitment(_g1(c.point))


def _kzg_vk_from(kv) -> kzg.VerifierKey:
    return kzg.VerifierKey(g=_g1(kv.g), gamma_g=_g1(kv.gamma_g), h=_g2(kv.h),
                           tau_h=_g2(kv.tau_h), max_degree=int(kv.max_degree))


def _vk_from(vk) -> MarlinVerifyingKey:
    return MarlinVerifyingKey(
        kzg_vk=_kzg_vk_from(vk.kzg_vk),
        log_n=int(vk.log_n), log_x=int(vk.log_x),
        num_instance=int(vk.num_instance),
        log_ks=[int(v) for v in vk.log_ks], max_degree=int(vk.max_degree),
        index_comms=[_commitment(c) for c in vk.index_comms])


def proving_key_from(pk) -> MarlinProvingKey:
    """A proving key: its SRS, verifying key, circuit, slot layout and the
    matrices' padded COO slots and signed values (what the device prover
    reads; the host coefficient lists are not carried)."""
    srs = srs_from(pk.srs)
    matrices = [MatrixIndex(
        log_k=int(m.log_k), nnz=int(m.nnz),
        row_slots=np.asarray(m.row_slots, np.int64),
        col_slots=np.asarray(m.col_slots, np.int64),
        vals=np.asarray([_signed(v) for v in m.vals], np.int64),
        row_evals=None, col_evals=None, val_evals=None, row_coeffs=None,
        col_coeffs=None, val_coeffs=None, comm_row=_commitment(m.comm_row),
        comm_col=_commitment(m.comm_col), comm_val=_commitment(m.comm_val))
        for m in pk.matrices]
    return MarlinProvingKey(
        srs=srs, vk=_vk_from(pk.vk), r1cs=r1cs_from(pk.r1cs),
        log_n=int(pk.log_n), log_x=int(pk.log_x),
        var_to_slot=[int(v) for v in pk.var_to_slot], matrices=matrices)


def _ints(values):
    return [int(v) for v in values]


def plonk_proving_key_from(pk) -> PlonkProvingKey:
    """A Plonk proving key: the compiled circuit (gates, sigma, selector and
    sigma evaluations), the selector and sigma polynomials, the SRS and the
    verifying key's commitments."""
    d = pk.data
    data = PlonkCircuitData(
        n=int(d.n), log_n=int(d.log_n), omega=int(d.omega),
        ks=tuple(_ints(d.ks)), num_public=int(d.num_public),
        rows=[Gate(int(g.ql), int(g.qr), int(g.qo), int(g.qm), int(g.qc),
                   int(g.a), int(g.b), int(g.c)) for g in d.rows],
        sigma=_ints(d.sigma),
        s_sigma_evals=[_ints(col) for col in d.s_sigma_evals],
        selector_evals=[_ints(col) for col in d.selector_evals])
    vk = pk.vk
    return PlonkProvingKey(
        data=data, srs=srs_from(pk.srs),
        selector_polys=[_ints(p) for p in pk.selector_polys],
        s_sigma_polys=[_ints(p) for p in pk.s_sigma_polys],
        vk=PlonkVerifyingKey(
            n=int(vk.n), omega=int(vk.omega), ks=tuple(_ints(vk.ks)),
            num_public=int(vk.num_public),
            comm_selectors=[_commitment(c) for c in vk.comm_selectors],
            comm_s_sigma=[_commitment(c) for c in vk.comm_s_sigma],
            kzg_vk=_kzg_vk_from(vk.kzg_vk)))
