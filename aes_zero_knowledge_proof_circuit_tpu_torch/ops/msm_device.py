"""MSM on the 8-bit bucket scan — counterpart of ops/msm_jax.py.

`msm_device` always runs the stages of ops/msm_pallas.py (kernel K4 on
CUDA tensors), as the JAX `msm_device` reaches `msm_pallas` on a TPU. It
commits the index (marlin/indexer.py) and, with `msm_engine="pallas"`, the
prover's polynomials. The window sums come back to the host for the Horner
ladder (`fold_windows`, 8 doublings per window). The eager
`_window_sums`/`_segmented_add`/`_tree_reduce_sum` path of the JAX module,
which dodged XLA:TPU compile times, has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    AffinePoint,
    g1_infinity,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import (
    FR_LIMBS,
    R_MOD,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.limbs import ints_to_limbs

from ..utils.srs import pack_points
from . import msm_pallas
from .field import to_u32
from .msm import horner, points_from_packed, window_points


def scalars_to_digit_limbs(scalars: Sequence[int]) -> np.ndarray:
    """Standard-form scalars -> [N, 16] uint32 16-bit limbs."""
    return ints_to_limbs([s % R_MOD for s in scalars], FR_LIMBS)


def digit_limbs(scalars: torch.Tensor) -> torch.Tensor:
    """[n, 8] standard-form Fr limbs (prover.to_msm_digits) -> [n, 16]
    int32 16-bit limbs, on the same device."""
    v = to_u32(scalars)
    return torch.stack([v & 0xFFFF, v >> 16], dim=-1).reshape(
        v.shape[0], 2 * v.shape[1]).to(torch.int32)


def fold_windows(wsums: torch.Tensor) -> AffinePoint:
    """Combine [32, 3, 12] window sums on the host: sum_w 2^(8 w) S_w."""
    return horner(window_points(wsums), msm_pallas.WINDOW_BITS)


def msm_device(points: torch.Tensor, digits16: torch.Tensor,
               lanes: Optional[int] = None) -> AffinePoint:
    """sum_i s_i P_i over device points and [n, 16] 16-bit digit limbs;
    returns a host affine point."""
    if digits16.shape[0] == 0:
        return g1_infinity()
    return fold_windows(msm_pallas.window_sums(points, digits16, lanes))


def msm(points: Sequence[AffinePoint], scalars: Sequence[int],
        device) -> AffinePoint:
    """Host-API MSM with the bucket phase on `device`: usable as
    `kzg.commit(msm_fn=functools.partial(msm, device=...))`."""
    if len(points) == 0:
        return g1_infinity()
    pts = points_from_packed(pack_points(points), device)
    digits = torch.from_numpy(
        scalars_to_digit_limbs(scalars).astype(np.int32)).to(device)
    return msm_device(pts, digits)


class DevicePoints:
    """SRS powers on the device ([N, 2, 12] Montgomery affine, from
    utils/srs.device_powers) for repeated commits."""

    def __init__(self, points: torch.Tensor):
        self.points = points
        self.n = points.shape[0]

    def slice(self, start: int, length: int) -> torch.Tensor:
        # a short slice would misalign points with scalars: fail loudly
        if start < 0 or start + length > self.n:
            raise ValueError(f"SRS slice [{start}:{start + length}] exceeds "
                             f"{self.n} points")
        return self.points[start:start + length]

    def msm(self, scalars: Sequence[int], offset: int = 0) -> AffinePoint:
        digits = torch.from_numpy(scalars_to_digit_limbs(scalars).astype(
            np.int32)).to(self.points.device)
        return msm_device(self.slice(offset, digits.shape[0]), digits)
