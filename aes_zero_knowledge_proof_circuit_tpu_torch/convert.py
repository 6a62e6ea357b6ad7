"""The JAX package's state in the port's layout, and back.

JAX field elements are [N, D] float32 8-bit digits of a*R_f mod p in a
redundant band (ops/field_f32.py: Fr D = 34, R_f = 2^272; Fq D = 50,
R_f = 2^400); the port's are [N, L] u32 limbs of a*R_p mod p, fully reduced
(R_p = 2^256 / 2^384). The radixes differ, so a value moves between them by
one Montgomery product with R_p^2 / R_f (in) or R_f (out). Everything is
vectorized: no Python bigint per element.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.field import FieldOps, fq_ops, fr_ops
from .ops.msm import points_from_packed

FR_DIGITS = 34
FQ_DIGITS = 50

__all__ = ["fr_from_f32_digits", "fq_from_f32_digits", "fr_to_f32_digits",
           "fq_to_f32_digits", "points_from_packed"]


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
