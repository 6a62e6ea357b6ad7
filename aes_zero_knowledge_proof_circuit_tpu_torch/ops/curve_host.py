"""Host-side BLS12-377 elliptic curve groups G1, G2 and E(Fq12).

Host oracle for the TPU curve kernels (curve_jax.py / msm_jax.py) and the
group layer for the KZG verifier (kzg.py). Mirrors the role of ark-ec /
ark-bls12-377 in the reference stack (SURVEY.md §2b).

G1: y^2 = x^3 + 1 over Fq,           order = H1_COFACTOR * r
G2: y^2 = x^3 + B2 over Fq2 (sextic twist), subgroup of order r

Generators are the STANDARD ark-bls12-377 constants (the reference proves
over exactly these groups — src/lib.rs:47 `pub use ark_bls12_377::Fr`,
Cargo.lock:118), embedded below and known-answer-tested in
tests/test_curve_pairing_host.py: on-curve, order r, bilinear pairing.
The deterministic derivation (smallest-x, cofactor-cleared) is kept as
`derived_g1_generator` for the structural cross-check.
"""

from __future__ import annotations

import functools
from typing import Generic, Tuple, TypeVar

from .field_host import XI, Fq2, Fq12
from .field_params import (
    G1_ORDER,
    H1_COFACTOR,
    Q_MOD,
    R_MOD,
    TRACE,
    inv_mod,
    legendre,
    sqrt_mod,
)

F = TypeVar("F")


# ---------------------------------------------------------------------------
# Generic affine short-Weierstrass point (y^2 = x^3 + b) over a field with
# (+, -, *, inv) methods or int (Fq).
# ---------------------------------------------------------------------------


class _IntField:
    """Adapter giving Python ints (Fq) the same interface as Fq2/Fq12."""

    @staticmethod
    def add(a, b):
        return (a + b) % Q_MOD

    @staticmethod
    def sub(a, b):
        return (a - b) % Q_MOD

    @staticmethod
    def mul(a, b):
        return a * b % Q_MOD

    @staticmethod
    def neg(a):
        return -a % Q_MOD

    @staticmethod
    def inv(a):
        return inv_mod(a, Q_MOD)

    @staticmethod
    def is_zero(a):
        return a % Q_MOD == 0

    @staticmethod
    def scalar(k):
        return k % Q_MOD


class _ObjField:
    """Adapter for Fq2 / Fq12 objects."""

    def __init__(self, cls):
        self.cls = cls

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def mul(self, a, b):
        return a * b

    def neg(self, a):
        return -a

    def inv(self, a):
        return a.inv()

    def is_zero(self, a):
        return a.is_zero()

    def scalar(self, k):
        if self.cls is Fq2:
            return Fq2(k, 0)
        return Fq12.from_fq(k)


FQ_FIELD = _IntField()
FQ2_FIELD = _ObjField(Fq2)
FQ12_FIELD = _ObjField(Fq12)


class AffinePoint(Generic[F]):
    """Affine point or infinity on y^2 = x^3 + b over field `fld`."""

    __slots__ = ("x", "y", "inf", "fld", "b")

    def __init__(self, x, y, fld, b, inf: bool = False):
        self.x, self.y, self.inf, self.fld, self.b = x, y, inf, fld, b

    @staticmethod
    def infinity(fld, b) -> "AffinePoint":
        return AffinePoint(None, None, fld, b, inf=True)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        f = self.fld
        lhs = f.mul(self.y, self.y)
        rhs = f.add(f.mul(f.mul(self.x, self.x), self.x), self.b)
        return f.is_zero(f.sub(lhs, rhs))

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, AffinePoint):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf and o.inf
        f = self.fld
        return f.is_zero(f.sub(self.x, o.x)) and f.is_zero(f.sub(self.y, o.y))

    def __hash__(self):
        return hash(("inf",)) if self.inf else hash((repr(self.x), repr(self.y)))

    def neg(self) -> "AffinePoint":
        if self.inf:
            return self
        return AffinePoint(self.x, self.fld.neg(self.y), self.fld, self.b)

    def add(self, o: "AffinePoint") -> "AffinePoint":
        f = self.fld
        if self.inf:
            return o
        if o.inf:
            return self
        if f.is_zero(f.sub(self.x, o.x)):
            if f.is_zero(f.add(self.y, o.y)):
                return AffinePoint.infinity(f, self.b)
            # doubling
            num = f.mul(f.scalar(3), f.mul(self.x, self.x))
            den = f.mul(f.scalar(2), self.y)
            lam = f.mul(num, f.inv(den))
        else:
            lam = f.mul(f.sub(o.y, self.y), f.inv(f.sub(o.x, self.x)))
        x3 = f.sub(f.sub(f.mul(lam, lam), self.x), o.x)
        y3 = f.sub(f.mul(lam, f.sub(self.x, x3)), self.y)
        return AffinePoint(x3, y3, f, self.b)

    def double(self) -> "AffinePoint":
        return self.add(self)

    def mul_scalar(self, k: int) -> "AffinePoint":
        if k < 0:
            return self.neg().mul_scalar(-k)
        result = AffinePoint.infinity(self.fld, self.b)
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

G1_B = 1


def g1_point(x: int, y: int) -> AffinePoint:
    return AffinePoint(x % Q_MOD, y % Q_MOD, FQ_FIELD, G1_B)


def g1_infinity() -> AffinePoint:
    return AffinePoint.infinity(FQ_FIELD, G1_B)


# Standard ark-bls12-377 G1 generator (curves/bls12_377/src/curves/g1.rs
# G1_GENERATOR_X/Y; reference depends on these via Cargo.lock:118).
# Known-answer-tested: on-curve and r * G == infinity.
G1_GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GENERATOR_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030


@functools.lru_cache(maxsize=None)
def g1_generator() -> AffinePoint:
    """The standard ark-bls12-377 G1 generator."""
    return g1_point(G1_GENERATOR_X, G1_GENERATOR_Y)


@functools.lru_cache(maxsize=None)
def derived_g1_generator() -> AffinePoint:
    """Structural cross-check generator: smallest x with x^3+1 square, even
    y, cleared by the cofactor h1 = (u-1)^2/3 into the r-order subgroup."""
    x = 0
    while True:
        x += 1
        rhs = (x * x * x + G1_B) % Q_MOD
        if legendre(rhs, Q_MOD) == 1:
            y = sqrt_mod(rhs, Q_MOD)
            assert y is not None
            y = min(y, Q_MOD - y)
            p = g1_point(x, y).mul_scalar(H1_COFACTOR)
            if not p.inf:
                assert p.mul_scalar(R_MOD).inf, "cofactor clearing failed"
                return p


# ---------------------------------------------------------------------------
# G2: determine the correct sextic twist empirically
# ---------------------------------------------------------------------------


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


@functools.lru_cache(maxsize=None)
def _twist_params() -> Tuple[Fq2, int]:
    """Find (B2, #E'(Fq2)) for the sextic twist whose order is divisible by r.

    The six twists of E(Fq2) have orders q^2 + 1 - t' for
    t' in {t2, -t2, (t2±3f)/2, -(t2±3f)/2} with t2 = t^2 - 2q and
    t2^2 - 4q^2 = -3 f^2. We try B2 in {XI, 1/XI} and pick the combination
    where a few random points are killed by (order) and r | order.
    """
    t2 = TRACE * TRACE - 2 * Q_MOD
    f2sq = (4 * Q_MOD * Q_MOD - t2 * t2) // 3
    f2 = _isqrt(f2sq)
    assert f2 * f2 == f2sq, "CM discriminant structure violated"
    cands = []
    for tp in (t2, -t2, (t2 + 3 * f2) // 2, (t2 - 3 * f2) // 2,
               -(t2 + 3 * f2) // 2, -(t2 - 3 * f2) // 2):
        n = Q_MOD * Q_MOD + 1 - tp
        if n % R_MOD == 0:
            cands.append(n)
    assert cands, "no twist order divisible by r"
    for b2 in (XI, XI.inv()):
        for order in cands:
            ok = True
            for seed in range(3):
                p = _random_twist_point(b2, seed)
                if not p.mul_scalar(order).inf:
                    ok = False
                    break
            if ok:
                return b2, order
    raise RuntimeError("no valid twist found")


def _random_twist_point(b2: Fq2, seed: int) -> AffinePoint:
    """Deterministic point on y^2 = x^3 + b2 over Fq2 (not subgroup-checked)."""
    c0 = seed + 1
    c1 = 0
    while True:
        x = Fq2(c0, c1)
        rhs = x * x * x + b2
        y = rhs.sqrt()
        if y is not None and not y.is_zero():
            return AffinePoint(x, y, FQ2_FIELD, b2)
        c1 += 1


@functools.lru_cache(maxsize=None)
def g2_curve_b() -> Fq2:
    return _twist_params()[0]


@functools.lru_cache(maxsize=None)
def g2_cofactor() -> int:
    b2, order = _twist_params()
    return order // R_MOD


def g2_point(x: Fq2, y: Fq2) -> AffinePoint:
    return AffinePoint(x, y, FQ2_FIELD, g2_curve_b())


def g2_infinity() -> AffinePoint:
    return AffinePoint.infinity(FQ2_FIELD, g2_curve_b())


# Standard ark-bls12-377 G2 generator (curves/bls12_377/src/curves/g2.rs
# G2_GENERATOR_X/Y_C0/C1). The empirically-determined twist above equals
# arkworks' (B2 = Fq2(0, 1553...906) = 1/XI); known-answer-tested.
G2_GENERATOR_X_C0 = 233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294
G2_GENERATOR_X_C1 = 140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118
G2_GENERATOR_Y_C0 = 63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423
G2_GENERATOR_Y_C1 = 149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491


@functools.lru_cache(maxsize=None)
def g2_generator() -> AffinePoint:
    """The standard ark-bls12-377 G2 generator."""
    return g2_point(
        Fq2(G2_GENERATOR_X_C0, G2_GENERATOR_X_C1),
        Fq2(G2_GENERATOR_Y_C0, G2_GENERATOR_Y_C1),
    )


@functools.lru_cache(maxsize=None)
def derived_g2_generator() -> AffinePoint:
    """Structural cross-check: cofactor-cleared deterministic twist point."""
    b2 = g2_curve_b()
    cof = g2_cofactor()
    for seed in range(32):
        p = _random_twist_point(b2, seed).mul_scalar(cof)
        if not p.inf:
            assert p.mul_scalar(R_MOD).inf
            return p
    raise RuntimeError("failed to build G2 generator")


# ---------------------------------------------------------------------------
# Untwist: E'(Fq2) -> E(Fq12) with y^2 = x^3 + 1
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _untwist_powers() -> Tuple[Fq12, Fq12]:
    """(cx, cy) with psi(x, y) = (x*cx, y*cy) landing on E(Fq12): y^2=x^3+1.

    D-twist (B2 = 1/XI): psi = (x w^2, y w^3); M-twist (B2 = XI):
    psi = (x / w^2, y / w^3). Chosen by checking the image is on the curve.
    """
    from .field_host import W2, W3

    b2 = g2_curve_b()
    g = g2_generator()
    for cx, cy in ((W2, W3), (W2.inv(), W3.inv())):
        x = Fq12.from_fq2(g.x) * cx
        y = Fq12.from_fq2(g.y) * cy
        p = AffinePoint(x, y, FQ12_FIELD, Fq12.from_fq(1))
        if p.is_on_curve():
            return cx, cy
    raise RuntimeError("no untwist map found")


def untwist(p: AffinePoint) -> AffinePoint:
    """Map a G2 (twist) point into E(Fq12)."""
    if p.inf:
        return AffinePoint.infinity(FQ12_FIELD, Fq12.from_fq(1))
    cx, cy = _untwist_powers()
    return AffinePoint(
        Fq12.from_fq2(p.x) * cx, Fq12.from_fq2(p.y) * cy, FQ12_FIELD, Fq12.from_fq(1)
    )


def g1_order() -> int:
    return G1_ORDER
