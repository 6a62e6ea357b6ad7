"""Host-side (pure Python) field tower for BLS12-377.

This is the bit-exact oracle for every TPU kernel (SURVEY.md §4: "kernel-vs-
host-reference exactness tests") and the implementation used by the host-side
verifier (pairings are ms-scale; SURVEY.md §7 step 7).

Tower (matching the arkworks layout the reference depends on, SURVEY.md §2b):
    Fq2  = Fq [i] / (i^2 + 5)            non-residue -5
    Fq6  = Fq2[v] / (v^3 - XI)           XI = a sextic non-residue in Fq2
    Fq12 = Fq6[w] / (w^2 - v)

Elements are plain Python ints (Fq) or small tuples of them; all hot math on
TPU uses the f32-digit engine in field_f32.py instead.
"""

from __future__ import annotations

from .field_params import FQ2_NON_RESIDUE, Q_MOD, R_MOD, inv_mod, legendre, sqrt_mod

# ---------------------------------------------------------------------------
# Fq and Fr: plain ints with helper functions
# ---------------------------------------------------------------------------


def fq_add(a: int, b: int) -> int:
    return (a + b) % Q_MOD


def fq_mul(a: int, b: int) -> int:
    return a * b % Q_MOD


def fq_inv(a: int) -> int:
    return inv_mod(a, Q_MOD)


def fr_add(a: int, b: int) -> int:
    return (a + b) % R_MOD


def fr_mul(a: int, b: int) -> int:
    return a * b % R_MOD


def fr_inv(a: int) -> int:
    return inv_mod(a, R_MOD)


# ---------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2 - NR), NR = -5
# ---------------------------------------------------------------------------

_NR = FQ2_NON_RESIDUE  # i^2 = NR


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % Q_MOD
        self.c1 = c1 % Q_MOD

    # -- ring ops -----------------------------------------------------------
    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # Karatsuba: (a0 + a1 i)(b0 + b1 i), i^2 = NR
        v0 = self.c0 * o.c0 % Q_MOD
        v1 = self.c1 * o.c1 % Q_MOD
        c0 = (v0 + _NR * v1) % Q_MOD
        c1 = ((self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1) % Q_MOD
        return Fq2(c0, c1)

    def scalar_mul(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        return self * self

    def inv(self) -> "Fq2":
        # 1/(a0 + a1 i) = (a0 - a1 i) / (a0^2 - NR a1^2)
        norm = (self.c0 * self.c0 - _NR * self.c1 * self.c1) % Q_MOD
        ninv = inv_mod(norm, Q_MOD)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    def __repr__(self) -> str:
        return f"Fq2({self.c0}, {self.c1})"

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def is_square(self) -> bool:
        # x is a square in Fq2 iff its norm is a square in Fq
        norm = (self.c0 * self.c0 - _NR * self.c1 * self.c1) % Q_MOD
        return norm == 0 or legendre(norm, Q_MOD) == 1

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 (complex method for q = 3 mod 4 unsupported in
        general; uses the norm trick valid for any q)."""
        if self.is_zero():
            return Fq2.zero()
        if self.c1 == 0:
            s = sqrt_mod(self.c0, Q_MOD)
            if s is not None:
                return Fq2(s, 0)
            # sqrt lies along i: x = (0, t) with NR * t^2 = c0
            t = sqrt_mod(self.c0 * inv_mod(_NR, Q_MOD) % Q_MOD, Q_MOD)
            return Fq2(0, t) if t is not None else None
        # general: alpha = norm; if alpha not QR -> no sqrt
        alpha = (self.c0 * self.c0 - _NR * self.c1 * self.c1) % Q_MOD
        s = sqrt_mod(alpha, Q_MOD)
        if s is None:
            return None
        # delta = (c0 + s)/2; if not square try (c0 - s)/2
        inv2 = inv_mod(2, Q_MOD)
        for sgn in (s, -s % Q_MOD):
            delta = (self.c0 + sgn) * inv2 % Q_MOD
            if delta == 0 or legendre(delta, Q_MOD) == 1:
                x0 = sqrt_mod(delta, Q_MOD)
                if x0 is None or x0 == 0:
                    continue
                x1 = self.c1 * inv_mod(2 * x0 % Q_MOD, Q_MOD) % Q_MOD
                cand = Fq2(x0, x1)
                if cand * cand == self:
                    return cand
        return None


# Sextic non-residue in Fq2 used for Fq6/Fq12 and the G2 twist.
# arkworks BLS12-377 uses XI = (0, 1) = i  (i.e. u in their notation).
XI = Fq2(0, 1)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - XI)
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - v1 - v2) * XI + v0
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + v2 * XI
        c2 = (a0 + a2) * (b0 + b2) - v0 + v1 - v2
        return Fq6(c0, c1, c2)

    def mul_by_fq2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fq6":
        # v * (c0 + c1 v + c2 v^2) = c2*XI + c0 v + c1 v^2
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def square(self) -> "Fq6":
        return self * self

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * a0 - (a1 * a2) * XI
        t1 = (a2 * a2) * XI - a0 * a1
        t2 = a1 * a1 - a0 * a2
        # norm = a0 t0 + XI(a2 t1 + a1 t2)
        norm = a0 * t0 + (a2 * t1 + a1 * t2) * XI
        ninv = norm.inv()
        return Fq6(t0 * ninv, t1 * ninv, t2 * ninv)

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2
        )

    def __hash__(self) -> int:
        return hash((self.c0, self.c1, self.c2))

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 + v1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def inv(self) -> "Fq12":
        # 1/(a + b w) = (a - b w)/(a^2 - b^2 v)
        norm = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()
        ninv = norm.inv()
        return Fq12(self.c0 * ninv, -(self.c1 * ninv))

    def conjugate(self) -> "Fq12":
        """The Fq6-conjugation w -> -w (equals Frobenius^6 on Fq12)."""
        return Fq12(self.c0, -self.c1)

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def from_fq2(x: Fq2) -> "Fq12":
        return Fq12(Fq6(x, Fq2.zero(), Fq2.zero()), Fq6.zero())

    @staticmethod
    def from_fq(x: int) -> "Fq12":
        return Fq12.from_fq2(Fq2(x, 0))


# w and w-powers used for untwisting G2 points into E(Fq12):
# w^2 = v, v^3 = XI  =>  w^6 = XI.
W = Fq12(Fq6.zero(), Fq6.one())
W2 = W * W  # = v in Fq6 embedded
W3 = W2 * W
