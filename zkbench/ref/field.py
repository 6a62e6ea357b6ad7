"""BLS12-377's fields and its G1 group, in plain Python integers.

Fr (r, 253 bits) is the circuit's field; G1 is y^2 = x^3 + 1 over Fq (q,
377 bits). Points are affine pairs `(x, y)` or `None` for infinity;
sums and multiples run in Jacobian coordinates and come back affine. The
2-adic roots of unity follow the same canonical tower as the program's
domains (the smallest non-square g, g^T, squared down), so both sides
interpolate over the same subgroups.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

U = 0x8508C00000000001
R_MOD = U**4 - U**2 + 1
Q_MOD = ((U - 1) ** 2 * (U**4 - U**2 + 1)) // 3 + U
TWO_ADICITY = 47
T_ODD = (R_MOD - 1) >> TWO_ADICITY

# the standard ark-bls12-377 G1 generator
G1_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030
G = (G1_X, G1_Y)

Point = Optional[Tuple[int, int]]


@functools.lru_cache(maxsize=None)
def fr_multiplicative_generator() -> int:
    """The smallest non-square of Fr: the tower's base, and the Plonk
    permutation's coset shift."""
    return next(g for g in range(2, 1000)
                if pow(g, (R_MOD - 1) // 2, R_MOD) != 1)


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity of Fr's canonical tower."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"no 2^{log_n} domain in Fr")
    w = pow(fr_multiplicative_generator(), T_ODD, R_MOD)
    for _ in range(TWO_ADICITY - log_n):
        w = w * w % R_MOD
    return w


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """A square root of a mod the odd prime p (Tonelli-Shanks), or None."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    s, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 1) % Q_MOD == 0


# -- Jacobian arithmetic (X, Y, Z) ~ (X / Z^2, Y / Z^3); Z = 0 is infinity ----

_INF = (1, 1, 0)


def _jac(p: Point):
    return _INF if p is None else (p[0], p[1], 1)


def _affine(j) -> Point:
    x, y, z = j
    if z % Q_MOD == 0:
        return None
    zi = pow(z, -1, Q_MOD)
    zi2 = zi * zi % Q_MOD
    return x * zi2 % Q_MOD, y * zi2 * zi % Q_MOD


def _dbl(j):
    x, y, z = j
    if z == 0 or y == 0:
        return _INF
    q = Q_MOD
    a = x * x % q
    b = y * y % q
    c = b * b % q
    d = 2 * ((x + b) * (x + b) - a - c) % q
    e = 3 * a % q
    x3 = (e * e - 2 * d) % q
    y3 = (e * (d - x3) - 8 * c) % q
    z3 = 2 * y * z % q
    return x3, y3, z3


def _add(j1, j2):
    if j1[2] == 0:
        return j2
    if j2[2] == 0:
        return j1
    q = Q_MOD
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1z1 = z1 * z1 % q
    z2z2 = z2 * z2 % q
    u1 = x1 * z2z2 % q
    u2 = x2 * z1z1 % q
    s1 = y1 * z2 * z2z2 % q
    s2 = y2 * z1 * z1z1 % q
    if u1 == u2:
        return _dbl(j1) if s1 == s2 else _INF
    h = (u2 - u1) % q
    i = 4 * h * h % q
    jj = h * i % q
    r = 2 * (s2 - s1) % q
    v = u1 * i % q
    x3 = (r * r - jj - 2 * v) % q
    y3 = (r * (v - x3) - 2 * s1 * jj) % q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % q
    return x3, y3, z3


def _mul(j, k: int):
    out = _INF
    for bit in bin(k)[2:] if k > 0 else "":
        out = _dbl(out)
        if bit == "1":
            out = _add(out, j)
    return out


def add(p: Point, q: Point) -> Point:
    return _affine(_add(_jac(p), _jac(q)))


def neg(p: Point) -> Point:
    return None if p is None else (p[0], (-p[1]) % Q_MOD)


def mul(p: Point, k: int) -> Point:
    """k * p, for any integer k (taken mod r: every point here lies in the
    order-r subgroup)."""
    return _affine(_mul(_jac(p), k % R_MOD))


def in_subgroup(p: Point) -> bool:
    """r * p is infinity."""
    return p is None or _mul(_jac(p), R_MOD)[2] % Q_MOD == 0


def combine(points, scalars) -> Point:
    """sum_i scalars[i] * points[i]."""
    acc = _INF
    for p, k in zip(points, scalars):
        acc = _add(acc, _mul(_jac(p), k % R_MOD))
    return _affine(acc)
