"""Plain PyTorch Jacobian arithmetic on BLS12-377 G1 over Fq limb tensors.

Counterparts of ops/msm_mxu.py `madd_in`, `jac_double_in` and `jac_add_in`,
vectorized over rows: a point batch is a tuple (x, y, z) of [N, 12] int32
Montgomery Fq tensors, infinity is z == 0. The mixed add is `affine_add`,
which the plain MSM's first round needs: both of its inputs are affine
there. The formulas are those of kernel K3 (csrc/msm.cu) and are COMPLETE:
P == Q doubles and P == -Q gives infinity (no incomplete-add contract). They run the plain
field functions, so the plain MSM built on them is independent of the
kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .field import fq_ops

FQ = fq_ops()
_mul, _add, _sub = FQ.plain_mul, FQ.plain_add, FQ.plain_sub

Jac = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def infinity(n: int, device) -> Jac:
    z = torch.zeros((n, FQ.L), dtype=torch.int32, device=device)
    return z, z.clone(), z.clone()


def is_inf(p: Jac) -> torch.Tensor:
    return FQ.is_zero(p[2])


def select(cond: torch.Tensor, a: Jac, b: Jac) -> Jac:
    return tuple(FQ.select(cond, u, v) for u, v in zip(a, b))


def jac_double(p: Jac) -> Jac:
    """dbl-2009-l (a = 0); infinity stays infinity (its rows are skipped)."""
    fin = ~is_inf(p)
    if bool(fin.all()):
        return _jac_double_finite(p)
    if not bool(fin.any()):
        return p
    i = torch.nonzero(fin).reshape(-1)
    d = _jac_double_finite(tuple(t[i] for t in p))
    out = tuple(t.clone() for t in p)
    for t, v in zip(out, d):
        t[i] = v
    return out


def _jac_double_finite(p: Jac) -> Jac:
    x, y, z = p
    t = _mul(y, z)
    z3 = _add(t, t)
    a = _mul(x, x)
    b = _mul(y, y)
    c = _mul(b, b)
    t = _add(x, b)
    t = _sub(_sub(_mul(t, t), a), c)
    d = _add(t, t)
    e = _add(_add(a, a), a)
    f = _mul(e, e)
    x3 = _sub(f, _add(d, d))
    c8 = _add(c, c)
    c8 = _add(c8, c8)
    c8 = _add(c8, c8)
    y3 = _sub(_mul(e, _sub(d, x3)), c8)
    return x3, y3, z3


def _degenerate(p: Jac, out: Jac, h: torch.Tensor, rr: torch.Tensor) -> Jac:
    """Rows with H == 0: P == Q (r == 0) doubles P, P == -Q gives
    infinity. The doubling runs only on the rows that need it."""
    h0 = FQ.is_zero(h)
    if not bool(h0.any()):
        return out
    dbl = h0 & FQ.is_zero(rr)
    out = tuple(t.clone() for t in out)
    for t in out:
        t[h0 & ~dbl] = 0
    if bool(dbl.any()):
        d = jac_double(tuple(t[dbl] for t in p))
        for t, v in zip(out, d):
            t[dbl] = v
    return out


def affine_add(p: Jac, q: Jac) -> Jac:
    """p + q for finite points given with z == 1 (mmadd-2007-bl: 6
    products against jac_add's 16)."""
    x1, y1, _z1 = p
    x2, y2, _z2 = q
    h = _sub(x2, x1)
    rr = _sub(y2, y1)
    hh = _mul(h, h)
    i4 = _add(hh, hh)
    i4 = _add(i4, i4)
    j = _mul(h, i4)
    r = _add(rr, rr)
    v = _mul(x1, i4)
    x3 = _sub(_sub(_sub(_mul(r, r), j), v), v)
    yj = _mul(y1, j)
    y3 = _sub(_mul(r, _sub(v, x3)), _add(yj, yj))
    return _degenerate(p, (x3, y3, _add(h, h)), h, rr)


def jac_add(p: Jac, q: Jac) -> Jac:
    """p + q, both Jacobian (add-2007-bl). Rows where either side is
    infinity take the other side; the formula runs on the rest only (bucket
    tables are mostly infinity at small sizes)."""
    p_inf, q_inf = is_inf(p), is_inf(q)
    out = select(p_inf, q, p)
    both = ~(p_inf | q_inf)
    if bool(both.all()):
        return _jac_add_finite(p, q)
    if bool(both.any()):
        i = torch.nonzero(both).reshape(-1)
        summed = _jac_add_finite(tuple(t[i] for t in p),
                                 tuple(t[i] for t in q))
        out = tuple(t.clone() for t in out)
        for t, v in zip(out, summed):
            t[i] = v
    return out


def _jac_add_finite(p: Jac, q: Jac) -> Jac:
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = _mul(z1, z1)
    z2z2 = _mul(z2, z2)
    u1 = _mul(x1, z2z2)
    u2 = _mul(x2, z1z1)
    s1 = _mul(_mul(y1, z2), z2z2)
    s2 = _mul(_mul(y2, z1), z1z1)
    h = _sub(u2, u1)
    rr = _sub(s2, s1)
    i4 = _add(h, h)
    i4 = _mul(i4, i4)
    j = _mul(h, i4)
    r = _add(rr, rr)
    v = _mul(u1, i4)
    t = _add(z1, z2)
    z3 = _mul(_sub(_sub(_mul(t, t), z1z1), z2z2), h)
    x3 = _sub(_sub(_sub(_mul(r, r), j), v), v)
    sj = _mul(s1, j)
    y3 = _sub(_mul(r, _sub(v, x3)), _add(sj, sj))
    return _degenerate(p, (x3, y3, z3), h, rr)


def run_sums(key: torch.Tensor, pts: Jac, n_out: int, affine: bool) -> Jac:
    """Table [n_out] of the sums of the rows of `pts` that share a key (key
    non-decreasing; rows with no point are infinity), by a pairwise tree:
    log2 of the longest run rounds of one vectorized add each. With
    `affine` every row is finite with z == 1 and the first round uses
    affine_add."""
    dev = key.device
    acc = tuple(t.clone() for t in pts)
    add = affine_add if affine else jac_add
    while key.shape[0]:
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        run = torch.cumsum(first.to(torch.int64), 0) - 1
        starts = torch.nonzero(first).reshape(-1)
        pos = torch.arange(key.shape[0], device=dev) - starts[run]
        run_len = torch.bincount(run)
        if int(run_len.max()) <= 1:
            break
        pair = (pos % 2 == 0) & (pos + 1 < run_len[run])
        i = torch.nonzero(pair).reshape(-1)
        summed = add(tuple(a[i] for a in acc), tuple(a[i + 1] for a in acc))
        add = jac_add
        for a, s in zip(acc, summed):
            a[i] = s
        even = pos % 2 == 0
        key = key[even]
        acc = tuple(a[even] for a in acc)
    table = infinity(n_out, dev)
    for t, a in zip(table, acc):
        t[key] = a
    return table
