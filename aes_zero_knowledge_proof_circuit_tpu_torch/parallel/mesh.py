"""Device mesh — counterpart of parallel/mesh.py.

A single-controller mesh, as the JAX package's `jax.sharding.Mesh` is: one
process drives every device, and a sharded call is one call that returns
one result. A `Mesh` is a tuple of torch devices with the axis name of
`CONFIG.mesh_axis`; a device may repeat, so N logical shards can sit on one
card. Data moves between devices by `Tensor.to` (peer to peer between the
cards of one host), which PyTorch orders after the work already queued on
the current streams of both devices. Work on a shard runs under
`on_device(its device)`: the kernels launch on the current CUDA device.
A mesh whose cards are not visible raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.config import CONFIG
from ..utils.device import resolve_device


def _normal(device) -> torch.device:
    """`device` with its index: cuda means cuda:0, as the kernels see it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is not visible: "
                             f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", index)
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `devices[i]` holds shard i."""

    devices: Tuple[torch.device, ...]
    axis: str = CONFIG.mesh_axis

    def __post_init__(self):
        devs = tuple(_normal(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh mixes device types: {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where sharded results come back to."""
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """`devices` as given, or `n_devices` shards on the visible cards
    (cuda:(i mod the card count); every card once by default), or on the
    CPU with device="cpu" (one shard by default)."""
    if devices is not None:
        return Mesh(tuple(devices))
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        return Mesh(tuple(torch.device("cuda", i % count) for i in range(n)))
    return Mesh((dev,) * (1 if n_devices is None else n_devices))


def on_device(device: torch.device):
    """The context a shard's work runs in: its card current for CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def chunk_bounds(total: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous (lo, hi) ranges of ceil(total / parts) rows, one a part;
    the last ones shorter or empty."""
    size = -(-total // parts)
    return [(min(i * size, total), min((i + 1) * size, total))
            for i in range(parts)]


def shard_leading(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t's leading axis padded with zero rows to a multiple of the mesh
    size, then cut into equal contiguous chunks, chunk i on devices[i]."""
    pad = -t.shape[0] % mesh.size
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    rows = t.shape[0] // mesh.size
    return [t[i * rows:(i + 1) * rows].to(d)
            for i, d in enumerate(mesh.devices)]


def replicated(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t on every mesh device: one copy a distinct device (shards that
    share a card share its tensor; t itself where it already lies)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = t.to(d)
    return [copies[d] for d in mesh.devices]
