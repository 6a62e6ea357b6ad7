"""SRS generation, checkpoint loading and device upload, free of JAX.

The JAX package keeps `PackedPowers` and `generate_srs_native` in
parallel/srs_gen.py, whose module imports jax, and its `load_srs`
(utils/serialize.py) imports that module; these are their jax-free copies.
The checkpoint format is the same `.npz`, written by the shared
utils/serialize.save_srs, so both packages read each other's checkpoints.
"""

from __future__ import annotations

import io
import logging
import random as _random

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.ops import kzg
from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import (
    AffinePoint,
    g1_generator,
    g1_infinity,
    g1_point,
    g2_generator,
)
from aes_zero_knowledge_proof_circuit_tpu.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu.utils.serialize import VERSION, _r_g2

from ..ops.msm import points_from_packed
from .native import native

log = logging.getLogger(__name__)


class PackedPowers:
    """Lazy list-like view over packed affine G1 powers: [N, 2, 24] uint32
    standard-form 16-bit limbs (the checkpoint layout); host AffinePoints are
    built only on item access. `.packed` feeds the device upload."""

    def __init__(self, packed: np.ndarray):
        self.packed = packed

    def __len__(self) -> int:
        return self.packed.shape[0]

    def _point(self, i: int) -> AffinePoint:
        x = sum(int(self.packed[i, 0, j]) << (16 * j) for j in range(24))
        y = sum(int(self.packed[i, 1, j]) << (16 * j) for j in range(24))
        if x == 0 and y == 0:
            return g1_infinity()
        return g1_point(x, y)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._point(i) for i in range(*idx.indices(len(self)))]
        return self._point(idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self._point(i)


def pack_points(points) -> np.ndarray:
    """Affine points (or a PackedPowers) -> [N, 2, 24] uint32 packed."""
    packed = getattr(points, "packed", None)
    if packed is not None:
        return packed
    out = np.zeros((len(points), 2, 24), np.uint32)
    for i, p in enumerate(points):
        if p.inf:
            continue
        for c, v in enumerate((int(p.x), int(p.y))):
            out[i, c] = np.frombuffer(v.to_bytes(48, "little"), "<u2")
    return out


def device_powers(srs: kzg.SRS, device) -> torch.Tensor:
    """The SRS G1 powers on `device` as [N, 2, 12] Montgomery Fq limbs."""
    return points_from_packed(pack_points(srs.powers_g1), device)


def generate_srs_native(max_degree: int, rng: _random.Random) -> kzg.SRS:
    """Powers-of-tau SRS through the native C++ fixed-base ladder. Raises
    when the native library is unavailable (no slow fallback)."""
    lib = native()
    tau = rng.randrange(1, R_MOD)
    gamma = rng.randrange(1, R_MOD)
    g = g1_generator()
    n = max_degree + 1
    scalars = [1] * n
    for i in range(1, n):
        scalars[i] = scalars[i - 1] * tau % R_MOD
    log.info("native SRS: %d fixed-base powers", n)
    packed = lib.g1_powers_fixed_base_packed(g, scalars)
    if packed is None:
        raise RuntimeError("native fixed-base ladder failed")
    powers = PackedPowers(packed)
    if powers[0] != g or powers[1] != g.mul_scalar(tau):
        raise RuntimeError("native SRS generation produced wrong powers")
    gamma_g = g.mul_scalar(gamma)
    gamma_powers = [gamma_g]
    for _ in range(kzg.HIDING_POWERS):
        gamma_powers.append(gamma_powers[-1].mul_scalar(tau))
    h = g2_generator()
    return kzg.SRS(max_degree=max_degree, powers_g1=powers,
                   gamma_powers_g1=gamma_powers, h=h, tau_h=h.mul_scalar(tau))


def load_srs(path: str) -> kzg.SRS:
    """Read a checkpoint written by utils/serialize.save_srs."""
    with np.load(path) as d:
        if int(d["version"]) != VERSION:
            raise ValueError("unsupported SRS version")
        max_degree = int(d["max_degree"])
        powers = np.ascontiguousarray(d["powers"])
        if powers.shape[0] < max_degree + 1:
            raise ValueError(f"SRS checkpoint holds {powers.shape[0]} powers, "
                             f"degree {max_degree} needs {max_degree + 1}")
        return kzg.SRS(
            max_degree=max_degree,
            powers_g1=PackedPowers(powers),
            gamma_powers_g1=list(PackedPowers(d["gamma_powers"])),
            h=_r_g2(io.BytesIO(d["h"].tobytes())),
            tau_h=_r_g2(io.BytesIO(d["tau_h"].tobytes())),
        )


def truncate_srs(srs: kzg.SRS, need: int) -> kzg.SRS:
    """Degree-`need` prefix of a powers-of-tau SRS (same tau, valid SRS)."""
    packed = pack_points(srs.powers_g1)
    if packed.shape[0] < need + 1:
        raise ValueError(f"SRS has {packed.shape[0]} powers, need {need + 1}")
    return kzg.SRS(max_degree=need,
                   powers_g1=PackedPowers(np.ascontiguousarray(packed[:need + 1])),
                   gamma_powers_g1=srs.gamma_powers_g1, h=srs.h,
                   tau_h=srs.tau_h)
