"""Host <-> limb-tensor conversions for TPU field elements.

TPU has no int64, so field elements cross the host<->device boundary as
[..., L] uint32 tensors holding 16-bit limbs (little-endian), L=16 for Fr
(253-bit), L=24 for Fq (377-bit) (SURVEY.md §7 step 1). This module is the
numpy boundary; all device math lives in the f32-digit engine
(field_f32.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .field_params import LIMB_BITS, MontgomeryCtx


def ints_to_limbs(values: Sequence[int], n_limbs: int) -> np.ndarray:
    """[N] python ints -> [N, L] uint32 16-bit limbs (little-endian).

    Bulk path via int.to_bytes + frombuffer (C speed) — this conversion sits
    on the host<->device boundary for SRS load and test oracles."""
    nbytes = n_limbs * (LIMB_BITS // 8)
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs)
    return arr.astype(np.uint32)


def limbs_to_ints(arr: np.ndarray) -> List[int]:
    """[..., L] limbs -> flat list of python ints (leading axes flattened)."""
    flat = np.ascontiguousarray(
        np.asarray(arr).reshape(-1, arr.shape[-1]).astype("<u2")
    )
    nbytes = flat.shape[1] * 2
    raw = flat.tobytes()
    return [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(flat.shape[0])
    ]


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    return ints_to_limbs([value], n_limbs)[0]


def to_mont(ctx: MontgomeryCtx, values: Sequence[int]) -> np.ndarray:
    """Ints (standard form) -> Montgomery-form limb tensor."""
    return ints_to_limbs([v % ctx.modulus * ctx.R_mod % ctx.modulus
                          for v in values], ctx.n_limbs)


def from_mont(ctx: MontgomeryCtx, arr: np.ndarray) -> List[int]:
    """Montgomery-form limb tensor -> ints (standard form)."""
    return [v * ctx.R_inv % ctx.modulus for v in limbs_to_ints(arr)]
