"""Montgomery Fq product on 8-bit digit columns — counterpart of
ops/msm_ntt_mul.py.

The JAX module's layout: a batch of Fq values is a [64, N] int32 tensor,
one value per column, as 8-bit digits little-endian in rows 0-49 plus the
carry row 50 (its transforms read rows 0-50 and ignore 51-63). Inputs lie
in its band: every digit in [0, DIGIT_BAND], value below about 6q.
`ntt_mul(a, b)` is the Montgomery product a * b * 2^-400 mod q (R = 2^400).

The TPU computes it as an int8 NTT-CRT convolution on the MXU because it
has no wide integer multiply. Kernel K5 (csrc/fq_cols.cu) uses the card's
32x32->64 multiply instead: per column it packs the digits into 13 u32
words (x < 2^410), brings x below 3q as x - k q with k one less than a
double-precision estimate of x / q, multiplies the two with the CIOS
product of csrc/field.cuh (R' = 2^384: a b 2^-384 mod q) and divides by
2^16 with one 16-bit Montgomery step, (v + m q) / 2^16 with m = -v mod
2^16, and one conditional subtraction. It writes canonical digits (value
below q, rows 48-63 zero), a stronger form than the reference's value
below 1.1q, so results are compared as canonical integers
(`cols_to_ints`). `plain_ntt_mul` is the same computation with the plain
field functions of ops/field.py.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .field_params import Q_MOD

from .. import kernels
from .field import _normalize, aligned, fq_ops, from_halves, halves

FQ = fq_ops()
DIGITS = 50              # 8-bit digits of a value
ROWS_READ = DIGITS + 1   # plus the carry row
PAD_IN = 64
R_BITS = 8 * DIGITS
R_INT = 1 << R_BITS
DIGIT_BAND = 319
_INV_Q = 1.0 / Q_MOD     # the kernel's INV_Q: Python rounds it correctly


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


def _reduced(cols: torch.Tensor) -> torch.Tensor:
    """[64, N] digit columns -> [N, 12] limbs of x - k q < 3q, the kernel's
    operand: x the value of rows 0-50, k = max(0, floor(x / q) - 1) from
    the same double-precision estimate of x / q (any k in range gives the
    same product)."""
    d = cols[:ROWS_READ].to(torch.int64).T              # [N, 51]
    n = d.shape[0]
    words = torch.zeros((n, 14), dtype=torch.int64, device=d.device)
    for j in range(ROWS_READ):
        words[:, j // 4] += d[:, j] << (8 * (j % 4))
    w = _normalize(words, 32)                           # x < 2^410
    xd = (w[:, 12].double() * 2.0 ** 384 + w[:, 11].double() * 2.0 ** 352
          + w[:, 10].double() * 2.0 ** 320)
    k = (torch.floor(xd * _INV_Q) - 1).clamp(min=0).to(torch.int64)
    q16 = FQ.const("p16x", cols.device)                 # [25] half-limbs
    x16 = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(n, 28)[:, :27]
    kq = torch.zeros_like(x16)
    for i, kh in enumerate((k & 0xFFFF, k >> 16)):     # x / q < 2^32
        kq[:, i:i + 25] += kh[:, None] * q16
    return from_halves(_normalize(x16 - kq, 16)[:, :2 * FQ.L])


def _div_2_16(v: torch.Tensor) -> torch.Tensor:
    """[N, 12] limbs v < q -> int64 [N, 24] half-limbs of v 2^-16 mod q,
    canonical: (v + m q) / 2^16 with m = -v mod 2^16, less q if above."""
    q16 = FQ.const("p16x", v.device)
    h = halves(v)
    m = (-h[:, 0]) & 0xFFFF
    t = torch.cat([h, torch.zeros_like(h[:, :1])], 1) + m[:, None] * q16
    u = _normalize(t, 16)[:, 1:]                        # < 2q, 24 columns
    d = _normalize(torch.cat([u, torch.zeros_like(u[:, :1])], 1) - q16, 16)
    return torch.where((d[:, -1] < 0)[:, None], u, d[:, :-1])


def plain_ntt_mul(a_cols: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: canonical digit columns of a b 2^-400 mod q."""
    dev = a_cols.device
    res = _div_2_16(FQ.plain_mul(_reduced(a_cols), _reduced(b_cols)))
    digits = torch.stack([res & 0xFF, res >> 8], -1).reshape(res.shape[0], 48)
    out = torch.zeros((PAD_IN, res.shape[0]), dtype=torch.int32, device=dev)
    out[:48] = digits.T.to(torch.int32)
    return out


def ntt_mul(a_cols: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: the Montgomery product (R = 2^400) of [64, N] digit
    columns. Plain version on CPU tensors, the kernel on CUDA (which takes
    four columns a thread: N is padded with zero columns to a multiple of
    4, and the result cut back to N)."""
    _check(a_cols, b_cols)
    if a_cols.device.type == "cpu":
        return plain_ntt_mul(a_cols, b_cols)
    if a_cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_cols.device}")
    kernels.check_device(a_cols)
    n = a_cols.shape[1]
    pad = -n % 4
    if pad:
        a, b = (torch.nn.functional.pad(x, (0, pad)) for x in (a_cols, b_cols))
    else:
        a, b = aligned(a_cols), aligned(b_cols)
    out = torch.empty_like(a)
    _launch(a, b, out)
    return out[:, :n].contiguous() if pad else out


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """K5 on [64, N] int32 CUDA columns, contiguous and 16-byte aligned, N
    a multiple of 4, into `out` of the same shape: the kernel alone, after
    ntt_mul's checks (and what the kernel's timing calls)."""
    kernels.fq_cols_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        a.shape[1])
