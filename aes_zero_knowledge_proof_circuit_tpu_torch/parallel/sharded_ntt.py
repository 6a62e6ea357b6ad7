"""Multi-device NTT: four-step (Bailey) decomposition over the mesh —
counterpart of parallel/sharded_ntt.py.

n = n1 n2 coefficients are read as a [n2, n1] matrix A (index j2 n1 + j1):

    X[k1 n2 + k2] = sum_j1 w_n1^(j1 k1) w_n^(j1 k2) sum_j2 A[j2, j1] w_n2^(j2 k2)

Device d takes its n1 / ndev columns j1, each turned into a contiguous row,
runs one batched K2 of length n2 over them (`NTTEngine.ntt_rows`) and
multiplies by its slice of the twiddles w_n^(j1 k2) (K1). The exchange that
the JAX package expresses as its second sharding constraint follows: device
d' receives the k2 range it owns from every device, as rows over j1, and
runs one batched K2 of length n1. Row k2, entry k1 is X[k1 n2 + k2]: the
first device gathers the rows back in natural order. The inverse runs the
inverse transforms, which scale by 1/n2 and 1/n1, and the inverse twiddles.
Results are exact: bit for bit the single-device transform.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..ops.field import fr_ops, table_built
from ..ops.field_params import R_MOD, root_of_unity
from ..ops.ntt import ntt_engine
from ..ops.poly import powers, scalar
from .mesh import Mesh, chunk_bounds, on_device

F = fr_ops()


def four_step_split(log_n: int, ndev: int) -> Tuple[int, int]:
    """(log n1, log n2) of a transform of 2^log_n over ndev devices: n1 at
    least ndev and about sqrt(n) (prover_jax._four_step_split)."""
    log_n1 = max((ndev - 1).bit_length(), log_n // 2)
    return log_n1, log_n - log_n1


@functools.lru_cache(maxsize=None)
def _twiddles(mesh: Mesh, log_n1: int, log_n2: int, inverse: bool):
    """Per shard, [its columns, n2, 8] Montgomery w^(j1 k2) (w the n-th
    root, or its inverse), on its device; None for a shard without columns.
    Built from two tables of about sqrt(n) powers, w^e = lo[e mod 2^h]
    hi[e >> h], so no device holds more than its own slice."""
    log_n = log_n1 + log_n2
    n2 = 1 << log_n2
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, R_MOD)
    h = log_n // 2
    out = []
    for d, (c0, c1) in zip(mesh.devices, chunk_bounds(1 << log_n1,
                                                      mesh.size)):
        if c0 == c1:
            out.append(None)
            continue
        with on_device(d):
            lo = powers(scalar(w, d), 1 << h)
            hi = powers(scalar(pow(w, 1 << h, R_MOD), d), 1 << (log_n - h))
            e = (torch.arange(c0, c1, device=d)[:, None]
                 * torch.arange(n2, device=d)[None, :]).reshape(-1)
            e &= (1 << log_n) - 1
            tw = F.mul(lo[e & ((1 << h) - 1)], hi[e >> h])
            out.append(tw.view(c1 - c0, n2, F.L))
            table_built(d)
    return tuple(out)


def _rows(log_n: int, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The (inverse) NTT of every row of [B, 2^log_n, 8] on x's device."""
    eng = ntt_engine(log_n, x.device)
    return eng.intt_rows(x) if inverse else eng.ntt_rows(x)


def ntt_sharded(mesh: Mesh, coeffs: torch.Tensor, log_n1: int, log_n2: int,
                inverse: bool = False) -> torch.Tensor:
    """(Inverse) NTT of a flat [2^(log_n1 + log_n2), 8] tensor on the mesh's
    first device, natural order in and out, returned on that device."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    if coeffs.shape != (n1 * n2, F.L) or coeffs.device != mesh.first:
        raise ValueError(f"expected [{n1 * n2}, {F.L}] on {mesh.first}, got "
                         f"{tuple(coeffs.shape)} on {coeffs.device}")
    twiddles = _twiddles(mesh, log_n1, log_n2, inverse)
    cols = [(d, c0, c1, tw) for d, (c0, c1), tw in zip(
        mesh.devices, chunk_bounds(n1, mesh.size), twiddles) if c0 < c1]
    ks = [(d, k0, k1) for d, (k0, k1) in zip(
        mesh.devices, chunk_bounds(n2, mesh.size)) if k0 < k1]
    # Each step is queued for every device before the next step: a copy
    # runs on its source's stream, so a device's copies queued behind
    # another's transform would wait for it.
    a = coeffs.view(n2, n1, F.L)
    xs = [a[:, c0:c1].transpose(0, 1).contiguous().to(d)
          for d, c0, c1, _tw in cols]
    parts = []            # pass 1: device d's columns as rows [c, n2]
    for (d, c0, c1, tw), x in zip(cols, xs):
        with on_device(d):
            y = _rows(log_n2, x, inverse)
            parts.append(F.mul(y.view(-1, F.L), tw.view(-1, F.L)).view(
                c1 - c0, n2, F.L))
    del xs
    # the exchange: device d' receives its k2 range [k, n1] from every one
    blocks = [[p[:, k0:k1].to(d) for p in parts] for d, k0, k1 in ks]
    del parts
    rows = []             # pass 2, on the rows [k, n1]
    for (d, _k0, _k1), bs in zip(ks, blocks):
        with on_device(d):
            rows.append(_rows(log_n1, torch.cat(bs).transpose(0, 1)
                              .contiguous(), inverse))
    del blocks
    out = torch.empty((n1, n2, F.L), dtype=torch.int32, device=mesh.first)
    for (_d, k0, k1), r in zip(ks, rows):
        out[:, k0:k1] = r.to(mesh.first).transpose(0, 1)
    return out.view(n1 * n2, F.L)
