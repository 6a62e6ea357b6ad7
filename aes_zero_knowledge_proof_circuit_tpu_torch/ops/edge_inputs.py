"""Inputs that reach the edge branches of K4 and K5, shared by chip_smoke.py
and the card tests (tests/test_torch_cuda.py).

`k4_edge_points` puts equal, opposite and infinity points into one bucket of
an 8-bit MSM, so that a tree level doubles, cancels and passes infinity
through. `fq_columns` makes digit columns at the edges of `ntt_mul`'s input
band: redundant digits up to 318, 0, 1, q - 1 and a value above q.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import fq_ops
from .msm_ntt_mul import PAD_IN, Q_MOD, ints_to_cols


def k4_edge_points(points: torch.Tensor, n: int) -> torch.Tensor:
    """The first n points with, where n > 11, the window-0 bucket of digit
    0x5A (scalars 1-299, in index order) opening with Q four times (P + P
    at levels 0 and 1), Q, Q, -Q, -Q (2Q + (-2Q) cancels at level 1), an
    infinity point and -R beside R (P + (-P) at level 0)."""
    pts = points[:n].clone()
    if n > 11:
        fq = fq_ops()
        neg = lambda p: torch.stack([p[0], fq.plain_sub(torch.zeros_like(
            p[1]), p[1])])
        pts[2:7] = pts[1]
        pts[7] = pts[8] = neg(pts[1])
        pts[9] = 0
        pts[11] = neg(pts[10])
    return pts


def fq_columns(n: int, gen: np.random.Generator) -> np.ndarray:
    """[64, n] digit columns (n >= 4) in ntt_mul's input band: random values
    below 2^376 in canonical digits, every fourth column with 63 added to
    its digits 0-45 (redundant digits up to 318), and edge columns 0, 1,
    q - 1 and a value above q in band digits."""
    cols = np.zeros((PAD_IN, n), np.int32)
    cols[:47] = gen.integers(0, 256, size=(47, n), dtype=np.int32)
    cols[:46, ::4] += 63
    edges = ints_to_cols([0, 1, Q_MOD - 1, 2**376], mont=False)
    q = ints_to_cols([Q_MOD - 1], mont=False)[:, 0]
    edges[:, 3] += q                       # 2^376 + q - 1, digits <= 510
    carry = edges[:, 3] >> 8
    edges[:, 3] = (edges[:, 3] & 255) + np.concatenate([[0], carry[:-1]])
    cols[:, :4] = edges
    return cols
