"""Marlin indexing on device — counterpart of marlin/indexer_jax.index_jax.

Same protocol output as the host oracle marlin/indexer.index: the index
polynomials row, col and val of A, B and C are interpolated over K with
kernel K2, and their 9 commitments run on the 8-bit bucket scan (kernel K4,
ops/msm_device.py), as index_jax commits through msm_device. The returned
MarlinProvingKey has numpy-backed matrices (slots int64, values signed) and
no host coefficient lists; it carries the COO arrays (`coo_np`) and the SRS
powers already on the device (`torch_points`) for TorchProver.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.marlin.indexer import (
    MarlinProvingKey,
    MarlinVerifyingKey,
    MatrixIndex,
    _next_pow2_log,
)
from aes_zero_knowledge_proof_circuit_tpu.models.r1cs import R1CS
from aes_zero_knowledge_proof_circuit_tpu.ops import kzg
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu.ops.poly_host import domain

from ..ops import poly as P
from ..ops.field import fr_ops
from ..ops.msm_device import DevicePoints, digit_limbs, msm_device
from ..utils.srs import device_powers
from .prover import _small_to_mont, coo_arrays, to_msm_digits

F = fr_ops()


def var_slots(r1cs: R1CS):
    """(log_x, log_n, var_to_slot): instance variable j at H[j * n/|X|],
    witness variables in the remaining slots in order."""
    log_x = _next_pow2_log(r1cs.num_instance)
    x_size = 1 << log_x
    log_n = _next_pow2_log(max(r1cs.num_constraints, r1cs.num_variables))
    while (1 << log_n) - x_size < r1cs.num_witness or (1 << log_n) < x_size:
        log_n += 1
    n = 1 << log_n
    stride = n // x_size
    var_to_slot = np.zeros(r1cs.num_variables, np.int64)
    var_to_slot[: r1cs.num_instance] = np.arange(r1cs.num_instance) * stride
    free = np.ones(n, bool)
    free[::stride] = False
    var_to_slot[r1cs.num_instance:] = np.nonzero(free)[0][: r1cs.num_witness]
    return log_x, log_n, var_to_slot.tolist()


def index(r1cs: R1CS, srs: kzg.SRS, device) -> MarlinProvingKey:
    dev = torch.device(device)
    log_x, log_n, var_to_slot = var_slots(r1cs)
    n = 1 << log_n
    h = domain(log_n)
    points = device_powers(srs, dev)
    srs_dev = DevicePoints(points)
    h_pows = P.powers(P.scalar(h.omega, dev), n)
    n_inv = P.scalar(pow(n, -1, R_MOD), dev)
    v2s = np.asarray(var_to_slot, np.int64)

    matrices: List[MatrixIndex] = []
    comms: List[kzg.Commitment] = []
    coo_np = coo_arrays(r1cs)
    for ri, ci, vals in coo_np:
        nnz = vals.shape[0]
        log_k = _next_pow2_log(nnz)
        k = 1 << log_k
        pad = k - nnz
        row_slots = np.pad(ri, (0, pad))
        col_slots = np.pad(v2s[ci], (0, pad))
        vals_signed = np.pad(vals, (0, pad))
        row_evals = h_pows[torch.as_tensor(row_slots, device=dev)]
        col_evals = h_pows[torch.as_tensor(col_slots, device=dev)]
        val_norm = F.mul(F.mul(_small_to_mont(
            torch.as_tensor(vals_signed, device=dev)), col_evals), n_inv)
        for coeffs in (P.intt(log_k, row_evals), P.intt(log_k, col_evals),
                       P.intt(log_k, val_norm)):
            comms.append(kzg.Commitment(msm_device(
                srs_dev.slice(0, k), digit_limbs(to_msm_digits(coeffs)))))
        matrices.append(MatrixIndex(
            log_k=log_k, nnz=nnz, row_slots=row_slots, col_slots=col_slots,
            vals=vals_signed, row_evals=None, col_evals=None, val_evals=None,
            row_coeffs=None, col_coeffs=None, val_coeffs=None,
            comm_row=comms[-3], comm_col=comms[-2], comm_val=comms[-1]))

    need = max(2 * n + 2, 2 * max(m.k for m in matrices))
    if srs.max_degree < need:
        raise ValueError(f"SRS degree {srs.max_degree} below required {need}")
    vk = MarlinVerifyingKey(
        kzg_vk=srs.verifier_part(), log_n=log_n, log_x=log_x,
        num_instance=r1cs.num_instance, log_ks=[m.log_k for m in matrices],
        max_degree=srs.max_degree, index_comms=comms)
    pk = MarlinProvingKey(srs=srs, vk=vk, r1cs=r1cs, log_n=log_n, log_x=log_x,
                          var_to_slot=var_to_slot, matrices=matrices)
    pk.coo_np = coo_np
    pk.torch_points = points
    return pk
