"""Montgomery Fq product on 8-bit digit columns — counterpart of
ops/msm_ntt_mul.py.

The JAX module's layout: a batch of Fq values is a [64, N] int32 tensor,
one value per column, as 8-bit digits little-endian in rows 0-49 plus the
carry row 50 (its transforms read rows 0-50 and ignore 51-63). Inputs lie
in its band: every digit in [0, DIGIT_BAND], value below about 6q.
`ntt_mul(a, b)` is the Montgomery product a * b * 2^-400 mod q (R = 2^400).

The TPU computes it as an int8 NTT-CRT convolution on the MXU because it
has no wide integer multiply. Kernel K5 (csrc/fq_cols.cu) uses the card's
32x32->64 multiply instead: per column it packs the digits into u32 limbs,
maps the value to the port's Montgomery-384 form (x = lo + hi 2^384 ->
lo R^2 / R + hi R^3 / R = x R mod q), multiplies with the CIOS product of
csrc/field.cuh, and corrects the radix with one product by the integer
2^-400 mod q. It writes canonical digits (value below q, rows 48-63 zero),
a stronger form than the reference's value below 1.1q, so results are
compared as canonical integers (`cols_to_ints`). `plain_ntt_mul` is the
same computation with the plain field functions of ops/field.py.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import Q_MOD

from .. import kernels
from .field import _normalize, fq_ops, from_u32, to_u32

FQ = fq_ops()
DIGITS = 50              # 8-bit digits of a value
ROWS_READ = DIGITS + 1   # plus the carry row
PAD_IN = 64
R_BITS = 8 * DIGITS
R_INT = 1 << R_BITS
DIGIT_BAND = 319
_INV_R400 = pow(2, -R_BITS, Q_MOD)


def ints_to_cols(values: Sequence[int], mont: bool = True) -> np.ndarray:
    """list[int] -> [64, N] int32 digit columns (Montgomery form, R = 2^400,
    unless mont=False)."""
    vals = [int(v) % Q_MOD for v in values]
    if mont:
        vals = [v * R_INT % Q_MOD for v in vals]
    raw = b"".join(v.to_bytes(DIGITS, "little") for v in vals)
    out = np.zeros((PAD_IN, len(vals)), np.int32)
    out[:DIGITS] = np.frombuffer(raw, np.uint8).reshape(len(vals), DIGITS).T
    return out


def cols_to_ints(arr, mont: bool = True) -> List[int]:
    """[64, N] digit columns (any digits, all 64 rows) -> canonical ints,
    leaving Montgomery form unless mont=False."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    x = torch.from_numpy(np.asarray(arr, np.int64).T.copy())
    # four spare bytes hold the carries of int32 digits
    x = torch.cat([x, torch.zeros((x.shape[0], 4), dtype=torch.int64)], 1)
    x = _normalize(x, 8)
    if bool((x[:, -1] < 0).any()):
        raise ValueError("negative column value")
    raw = x.to(torch.uint8).numpy().tobytes()
    width = x.shape[1]
    rinv = pow(R_INT % Q_MOD, -1, Q_MOD)
    out = []
    for i in range(x.shape[0]):
        v = int.from_bytes(raw[i * width:(i + 1) * width], "little") % Q_MOD
        out.append(v * rinv % Q_MOD if mont else v)
    return out


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for x in (a, b):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != PAD_IN:
            raise ValueError(f"expected [64, N] int32 digit columns, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    for x in (a, b):
        if x.shape[1] == 0:
            continue
        lo, hi = torch.aminmax(x[:ROWS_READ])
        if int(lo) < 0 or int(hi) > DIGIT_BAND:
            raise ValueError(f"digits outside [0, {DIGIT_BAND}]")


def _to_mont384(cols: torch.Tensor) -> torch.Tensor:
    """[64, N] digit columns -> [N, 12] Fq limbs of value * 2^384 mod q."""
    d = cols[:ROWS_READ].to(torch.int64).T              # [N, 51]
    n = d.shape[0]
    words = torch.zeros((n, 14), dtype=torch.int64, device=d.device)
    for j in range(ROWS_READ):
        words[:, j // 4] += d[:, j] << (8 * (j % 4))
    words = _normalize(words, 32)                       # value < 2^410
    lo = from_u32(words[:, :FQ.L])
    hi = torch.zeros_like(lo)
    hi[:, 0] = from_u32(words[:, FQ.L])
    dev = cols.device
    return FQ.plain_add(FQ.plain_mul(lo, FQ.const("r2", dev)),
                        FQ.plain_mul(hi, FQ.const("r3", dev)))


def plain_ntt_mul(a_cols: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: canonical digit columns of a b 2^-400 mod q."""
    dev = a_cols.device
    inv = _kernel_consts(str(dev))[2:]
    prod = FQ.plain_mul(_to_mont384(a_cols), _to_mont384(b_cols))
    res = to_u32(FQ.plain_mul(prod, inv))               # [N, 12] canonical
    shifts = torch.arange(0, 32, 8, device=dev)
    digits = ((res[:, :, None] >> shifts) & 0xFF).reshape(res.shape[0], 48)
    out = torch.zeros((PAD_IN, res.shape[0]), dtype=torch.int32, device=dev)
    out[:48] = digits.T.to(torch.int32)
    return out


def ntt_mul(a_cols: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: the Montgomery product (R = 2^400) of [64, N] digit
    columns. Plain version on CPU tensors, the kernel on CUDA."""
    _check(a_cols, b_cols)
    if a_cols.device.type == "cpu":
        return plain_ntt_mul(a_cols, b_cols)
    if a_cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_cols.device}")
    a, b = a_cols.contiguous(), b_cols.contiguous()
    consts = _kernel_consts(str(a.device))
    out = torch.empty_like(a)
    kernels.fq_cols_mul(a.data_ptr(), b.data_ptr(), consts.data_ptr(),
                        out.data_ptr(), a.shape[1])
    return out


@functools.lru_cache(maxsize=None)
def _kernel_consts(device: str) -> torch.Tensor:
    """[3, 12] limbs of 2^768, 2^1152 and 2^-400 mod q on `device`."""
    return FQ.from_ints([FQ.R2, FQ.R3, _INV_R400], device, mont=False)
