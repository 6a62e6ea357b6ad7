"""ark-serialize (v0.3) canonical point/field encodings for BLS12-377.

The reference serializes proofs/keys through arkworks' CanonicalSerialize
(deserialize_proof re-export, src/lib.rs:52; Cargo.lock ark-serialize 0.3.x).
This module reproduces the 0.3 wire layout so points are byte-compatible:

  Fr  canonical: 32 bytes LE (BigInteger256, standard form).
  Fq  canonical: 48 bytes LE (BigInteger384, standard form).
  G1 compressed: 48 bytes = x (Fq LE) with SWFlags in the top bits of the
                 LAST byte:   infinity = 1<<6,  negative-y = 1<<7.
                 "negative" means y > -y is FALSE, i.e. y <= q-y as ints
                 (ark-ec 0.3 GroupAffine::serialize: SWFlags::from_y_sign(
                 self.y > -self.y)). Infinity serializes x = 0 + inf flag.
  G1 uncompressed: 96 bytes = x (Fq LE, no flags) || y (Fq LE, flags).
  G2: same, with Fq2 coordinates serialized c0 || c1 and flags in the last
      byte of c1 (Fq2::serialize_with_flags delegates flags to c1).

Interop status (documented gap, VERDICT round-1 item 7): the layouts above
are implemented from the published ark-serialize/ark-ec 0.3 sources; the
offline environment has no cargo/network access to produce reference bytes,
so cross-validation is via known-answer tests on the standard generator
constants + round-trip/flag property tests (tests/test_ark_serialize.py).
The Marlin *transcript* remains self-defined (utils/transcript.py) — proofs
verify within this stack, with point encodings ark-canonical.
"""

from __future__ import annotations

from ..ops.curve_host import (
    AffinePoint,
    g1_infinity,
    g1_point,
    g2_infinity,
    g2_point,
)
from ..ops.field_host import Fq2
from ..ops.field_params import Q_MOD, R_MOD
from .errors import SerializationError

FR_BYTES = 32
FQ_BYTES = 48
INF_FLAG = 1 << 6
NEG_FLAG = 1 << 7


# -- field elements ----------------------------------------------------------


def fr_to_bytes(v: int) -> bytes:
    return (v % R_MOD).to_bytes(FR_BYTES, "little")


def fr_from_bytes(b: bytes) -> int:
    if len(b) != FR_BYTES:
        raise SerializationError("Fr must be 32 bytes")
    v = int.from_bytes(b, "little")
    if v >= R_MOD:
        raise SerializationError("Fr value out of range")
    return v


def fq_to_bytes(v: int) -> bytes:
    return (v % Q_MOD).to_bytes(FQ_BYTES, "little")


def fq_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= Q_MOD:
        raise SerializationError("Fq value out of range")
    return v


def _is_neg(y: int) -> bool:
    """ark 0.3 sign convention: NOT (y > -y) as canonical integers."""
    return not (y > (Q_MOD - y) % Q_MOD)


def _sqrt_fq(v: int):
    from ..ops.field_params import sqrt_mod

    return sqrt_mod(v, Q_MOD)


# -- G1 ----------------------------------------------------------------------


def g1_compressed(p: AffinePoint) -> bytes:
    if p.inf:
        out = bytearray(FQ_BYTES)
        out[-1] |= INF_FLAG
        return bytes(out)
    out = bytearray(fq_to_bytes(p.x))
    if _is_neg(p.y):
        out[-1] |= NEG_FLAG
    return bytes(out)


def g1_from_compressed(b: bytes) -> AffinePoint:
    if len(b) != FQ_BYTES:
        raise SerializationError("compressed G1 must be 48 bytes")
    raw = bytearray(b)
    flags = raw[-1] & (INF_FLAG | NEG_FLAG)
    raw[-1] &= ~(INF_FLAG | NEG_FLAG) & 0xFF
    x = fq_from_bytes(bytes(raw))
    if flags & INF_FLAG:
        if x != 0:
            raise SerializationError("infinity with nonzero x")
        return g1_infinity()
    rhs = (x * x * x + 1) % Q_MOD
    y = _sqrt_fq(rhs)
    if y is None:
        raise SerializationError("x not on curve")
    if _is_neg(y) != bool(flags & NEG_FLAG):
        y = Q_MOD - y
    p = g1_point(x, y)
    if not p.mul_scalar(R_MOD).inf:
        raise SerializationError("G1 point not in the r-order subgroup")
    return p


def g1_uncompressed(p: AffinePoint) -> bytes:
    if p.inf:
        out = bytearray(2 * FQ_BYTES)
        out[-1] |= INF_FLAG
        return bytes(out)
    return fq_to_bytes(p.x) + fq_to_bytes(p.y)


def g1_from_uncompressed(b: bytes) -> AffinePoint:
    if len(b) != 2 * FQ_BYTES:
        raise SerializationError("uncompressed G1 must be 96 bytes")
    raw = bytearray(b)
    flags = raw[-1] & (INF_FLAG | NEG_FLAG)
    raw[-1] &= ~(INF_FLAG | NEG_FLAG) & 0xFF
    x = fq_from_bytes(bytes(raw[:FQ_BYTES]))
    y = fq_from_bytes(bytes(raw[FQ_BYTES:]))
    if flags & INF_FLAG:
        return g1_infinity()
    p = g1_point(x, y)
    if not p.is_on_curve():
        raise SerializationError("G1 point not on curve")
    return p


# -- G2 ----------------------------------------------------------------------


def _fq2_to_bytes(c: Fq2) -> bytes:
    return fq_to_bytes(c.c0) + fq_to_bytes(c.c1)


def g2_compressed(p: AffinePoint) -> bytes:
    if p.inf:
        out = bytearray(2 * FQ_BYTES)
        out[-1] |= INF_FLAG
        return bytes(out)
    out = bytearray(_fq2_to_bytes(p.x))
    # ark Fq2 sign: lexicographic on (c1, c0) — is_positive iff
    # c1 > -c1, or c1 == 0 and c0 > -c0 (QuadExtField 0.3 cmp order)
    if _fq2_is_neg(p.y):
        out[-1] |= NEG_FLAG
    return bytes(out)


def _fq2_is_neg(y: Fq2) -> bool:
    if y.c1 != 0:
        return _is_neg(y.c1)
    return _is_neg(y.c0)


def g2_from_compressed(b: bytes) -> AffinePoint:
    if len(b) != 2 * FQ_BYTES:
        raise SerializationError("compressed G2 must be 96 bytes")
    raw = bytearray(b)
    flags = raw[-1] & (INF_FLAG | NEG_FLAG)
    raw[-1] &= ~(INF_FLAG | NEG_FLAG) & 0xFF
    c0 = fq_from_bytes(bytes(raw[:FQ_BYTES]))
    c1 = fq_from_bytes(bytes(raw[FQ_BYTES:]))
    if flags & INF_FLAG:
        if c0 or c1:
            raise SerializationError("infinity with nonzero x")
        return g2_infinity()
    from ..ops.curve_host import g2_curve_b

    x = Fq2(c0, c1)
    rhs = x * x * x + g2_curve_b()
    y = rhs.sqrt()
    if y is None:
        raise SerializationError("x not on twist")
    if _fq2_is_neg(y) != bool(flags & NEG_FLAG):
        y = -y
    p = g2_point(x, y)
    if not p.mul_scalar(R_MOD).inf:
        raise SerializationError("G2 point not in the r-order subgroup")
    return p


def g2_uncompressed(p: AffinePoint) -> bytes:
    if p.inf:
        out = bytearray(4 * FQ_BYTES)
        out[-1] |= INF_FLAG
        return bytes(out)
    return _fq2_to_bytes(p.x) + _fq2_to_bytes(p.y)


def g2_from_uncompressed(b: bytes) -> AffinePoint:
    if len(b) != 4 * FQ_BYTES:
        raise SerializationError("uncompressed G2 must be 192 bytes")
    raw = bytearray(b)
    flags = raw[-1] & (INF_FLAG | NEG_FLAG)
    raw[-1] &= ~(INF_FLAG | NEG_FLAG) & 0xFF
    vals = [fq_from_bytes(bytes(raw[i * FQ_BYTES:(i + 1) * FQ_BYTES]))
            for i in range(4)]
    if flags & INF_FLAG:
        return g2_infinity()
    p = g2_point(Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]))
    if not p.is_on_curve():
        raise SerializationError("G2 point not on twist")
    return p
