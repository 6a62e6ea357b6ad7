"""Multi-device Pippenger MSM: points and scalars sharded over the mesh —
counterpart of parallel/sharded_msm.py.

The scalars are cut into contiguous chunks of ceil(n / ndev) rows, the
padding the JAX package adds being zero scalars, which add nothing, so the
last chunks are just shorter. Each device runs the engine's MSM over its
chunk and its own replica of the points (K3 `ops/msm.msm_point` for "mxu",
K4 `ops/msm_device.msm_device_point` for "pallas"): the sum of the partial
MSMs is the MSM, as the sum of per-device window sums is in the JAX
package. The calling thread queues the shards one after another, each
under its card, and the cards work at once; the ndev partial points are
folded on the host, as the JAX package folds its window sums, and the sum
comes back as one XYZZ point on the mesh's first device. (A host thread a
card was slower: on four H100s it took 97.7 ms at 2^22 points on K3,
queued in turn 43.1 ms, one card 99.0 ms, `scripts/time_sharded_msm.py`;
the threads contend for the interpreter lock around every tensor call.)
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.curve_host import g1_infinity
from ..ops.msm import affine_to_xyzz, msm_point, xyzz_to_affine
from ..ops.msm_device import digit_limbs, msm_device_point
from .mesh import Mesh, chunk_bounds, on_device

ENGINES = ("mxu", "pallas")


def _partial(points: torch.Tensor, scalars: torch.Tensor, engine: str
             ) -> torch.Tensor:
    if engine == "pallas":
        return msm_device_point(points, digit_limbs(scalars))
    return msm_point(points, scalars)


def msm_sharded(mesh: Mesh, points_by_device: Sequence[torch.Tensor],
                scalars: torch.Tensor, engine: str = "mxu") -> torch.Tensor:
    """sum_i scalars[i] P_i as one XYZZ point [4, 12] on mesh.first.
    points_by_device[d]: the points P_0 .. P_(n-1) (or more) on
    mesh.devices[d], [N, 2, 12] Montgomery affine; scalars: [n, 8] standard
    Fr limbs, on any device."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if len(points_by_device) != mesh.size:
        raise ValueError(f"{len(points_by_device)} point replicas for a mesh "
                         f"of {mesh.size}")
    for d, pts in zip(mesh.devices, points_by_device):
        if pts.device != d or pts.shape[0] < scalars.shape[0]:
            raise ValueError(f"points [{pts.shape[0]}] on {pts.device} for a "
                             f"shard on {d} of {scalars.shape[0]} scalars")
    # the scalar chunks are copied out before any MSM is queued: a copy
    # runs on its source's stream, behind whatever that card has queued
    shards = [(d, points_by_device[i][lo:hi], scalars[lo:hi].to(d))
              for i, (d, (lo, hi)) in enumerate(zip(
                  mesh.devices, chunk_bounds(scalars.shape[0], mesh.size)))
              if lo < hi]
    partials = []
    for d, pts, sc in shards:
        with on_device(d):
            partials.append(_partial(pts, sc, engine))
    total = g1_infinity()
    for p in partials:
        total = total.add(xyzz_to_affine(p)[0])
    return affine_to_xyzz(total, mesh.first)
