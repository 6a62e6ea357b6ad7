"""Fixed-base G1 multiples of the powers of tau — counterpart of the device
half of parallel/srs_gen.py (`_window_tables`, `fixed_base_msm_device`,
`jacobian_to_affine_packed`).

    table   [32, 256, 2, 12] int32: T[w][d] = d 2^(8 w) G, affine Montgomery
            Fq (row d = 0 is infinity, x = y = 0), from `window_table`
    scalars [n, 8] int32: standard-form Fr limbs (the powers of tau)

`fixed_base` (kernel K6, csrc/srs.cu) sums, for each scalar, the table entry
of each of its 32 bytes: s G = sum_w T[w][byte_w(s)]. Its plain version
(`plain_fixed_base`) gathers the same rows and adds them with the plain
Jacobian add of ops/curve.py, window by window, as fixed_base_msm_device
does. `to_packed` normalizes XYZZ points to the SRS checkpoint layout [n, 2,
24] (16-bit limbs of standard-form x and y) with one Fq batch inversion
(K1 on CUDA tensors).
"""

from __future__ import annotations

import torch

from .. import kernels
from . import curve
from .curve_host import AffinePoint
from .field import fq_ops
from .msm import jac_to_xyzz

FQ = fq_ops()
WINDOWS = 32           # 8-bit windows of a 256-bit scalar
DIGITS = 256


def window_table(g: AffinePoint, device) -> torch.Tensor:
    """[32, 256, 2, 12] Montgomery affine T[w][d] = d 2^(8 w) g, d = 0 as
    infinity (x = y = 0), built with host point additions."""
    coords = []
    base = g
    for _w in range(WINDOWS):
        p = base
        coords += [0, 0]
        for _d in range(1, DIGITS):
            coords += [0, 0] if p.inf else [int(p.x), int(p.y)]
            p = p.add(base)
        for _ in range(8):
            base = base.double()
    return FQ.from_ints(coords, device).reshape(WINDOWS, DIGITS, 2, FQ.L)


def scalar_bytes(scalars: torch.Tensor) -> torch.Tensor:
    """[n, 8] standard Fr limbs -> [32, n] int64 bytes, least significant
    first."""
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    shifts = 8 * torch.arange(4, device=scalars.device)
    return ((v[:, :, None] >> shifts) & 0xFF).reshape(-1, WINDOWS).T


def _check(table: torch.Tensor, scalars: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.shape != (WINDOWS, DIGITS, 2,
                                                     FQ.L):
        raise ValueError(f"table must be [32, 256, 2, 12] int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or \
            scalars.shape[1] != 8:
        raise ValueError(f"scalars must be [n, 8] int32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if table.device != scalars.device:
        raise ValueError(f"table on {table.device}, scalars on "
                         f"{scalars.device}")


def fixed_base(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: [n, 4, 12] XYZZ Montgomery points s_i G. Plain version
    on CPU tensors, the kernel on CUDA."""
    _check(table, scalars)
    if scalars.device.type == "cpu":
        return plain_fixed_base(table, scalars)
    if scalars.device.type != "cuda":
        raise ValueError(f"no kernel for device {scalars.device}")
    kernels.check_device(scalars)
    table, scalars = table.contiguous(), scalars.contiguous()
    out = torch.empty((scalars.shape[0], 4, FQ.L), dtype=torch.int32,
                      device=scalars.device)
    kernels.srs_fixed_base(table.data_ptr(), scalars.data_ptr(),
                           scalars.shape[0], out.data_ptr())
    return out


def plain_fixed_base(table: torch.Tensor, scalars: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of K6: for each window, the table rows of the scalars'
    bytes as Jacobian points (z = 1, infinity for byte 0) added into the
    sum with curve.jac_add; [n, 4, 12] XYZZ."""
    dev = scalars.device
    digits = scalar_bytes(scalars)
    acc = curve.infinity(scalars.shape[0], dev)
    one = FQ.const("one", dev)
    for w in range(WINDOWS):
        d = digits[w]
        rows = table[w, d]
        z = FQ.select(d != 0, one.expand(d.shape[0], FQ.L),
                      torch.zeros_like(rows[:, 0]))
        acc = curve.jac_add(acc, (rows[:, 0], rows[:, 1], z))
    return jac_to_xyzz(acc)


def to_packed(points: torch.Tensor) -> torch.Tensor:
    """[n, 4, 12] XYZZ Montgomery points -> [n, 2, 24] int32 16-bit limbs
    of standard-form affine x and y (infinity as zeros), on the same
    device: one batch inversion of ZZZ (1/ZZZ = Z^-3, times ZZ is Z^-1)."""
    inv = FQ.batch_inv(points[:, 3].contiguous())
    zinv = FQ.mul(inv, points[:, 2].contiguous())
    x = FQ.to_canonical_limbs(FQ.mul(points[:, 0].contiguous(),
                                     FQ.square(zinv)))
    y = FQ.to_canonical_limbs(FQ.mul(points[:, 1].contiguous(), inv))
    v = torch.stack([x, y], dim=1)
    halves = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], dim=-1)
    return halves.reshape(points.shape[0], 2, 2 * FQ.L)
