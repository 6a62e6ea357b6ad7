"""The proof's bytes: read and written by the format's own rules.

Layout (version 2): "ZKAESTPU", u32 version; the commitments w, za, zb,
s, t, g1, g1_shift, h1; u32 m, then for each matrix g2, g2_shift, h2 and
sigma; u32 count and the evaluations at beta1; u32 count and, per
matrix, u32 count and its evaluations at beta2; then each opening's
point and hiding evaluation. Fr is 32 bytes little-endian; a G1 point is
ark-serialize 0.3's compressed form: x (48 bytes, little-endian) with
infinity as bit 6 and the sign of y as bit 7 of the last byte, y's sign
set where y <= q - y. A point must lie on the curve and in the order-r
subgroup; anything else, or bytes left over, is refused.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import List, Tuple

from .field import Point, Q_MOD, R_MOD, in_subgroup, sqrt_mod

MAGIC = b"ZKAESTPU"
VERSION = 2
INF_FLAG = 1 << 6
NEG_FLAG = 1 << 7


class ProofBytesError(ValueError):
    """The bytes are not a proof of this format."""


@dataclass
class Proof:
    comms: List[Point]              # w, za, zb, s, t, g1, g1_shift, h1
    comm_g2: List[Point]
    comm_g2_shift: List[Point]
    comm_h2: List[Point]
    sigmas: List[int]
    evals_beta1: List[int]
    evals_beta2: List[List[int]]
    openings: List[Tuple[Point, int]]   # (w, hiding eval.) at beta1, beta2


def _y_is_neg(y: int) -> bool:
    return not y > (Q_MOD - y) % Q_MOD


def _read(b: io.BytesIO, n: int) -> bytes:
    out = b.read(n)
    if len(out) != n:
        raise ProofBytesError("the bytes end early")
    return out


def _u32(b) -> int:
    return struct.unpack("<I", _read(b, 4))[0]


def _fr(b) -> int:
    v = int.from_bytes(_read(b, 32), "little")
    if v >= R_MOD:
        raise ProofBytesError("an Fr value out of range")
    return v


def _g1(b) -> Point:
    raw = bytearray(_read(b, 48))
    flags = raw[-1] & (INF_FLAG | NEG_FLAG)
    raw[-1] &= 0x3F
    x = int.from_bytes(raw, "little")
    if x >= Q_MOD:
        raise ProofBytesError("an Fq value out of range")
    if flags & INF_FLAG:
        if x or flags & NEG_FLAG:
            raise ProofBytesError("a malformed point at infinity")
        return None
    y = sqrt_mod(x * x * x + 1, Q_MOD)
    if y is None:
        raise ProofBytesError("a point off the curve")
    if _y_is_neg(y) != bool(flags & NEG_FLAG):
        y = Q_MOD - y
    if not in_subgroup((x, y)):
        raise ProofBytesError("a point outside the order-r subgroup")
    return x, y


def parse(data: bytes) -> Proof:
    b = io.BytesIO(data)
    if _read(b, 8) != MAGIC:
        raise ProofBytesError("bad magic")
    if _u32(b) != VERSION:
        raise ProofBytesError("unsupported version")
    comms = [_g1(b) for _ in range(8)]
    g2, g2s, h2, sigmas = [], [], [], []
    for _ in range(_u32(b)):
        g2.append(_g1(b))
        g2s.append(_g1(b))
        h2.append(_g1(b))
        sigmas.append(_fr(b))
    evals_beta1 = [_fr(b) for _ in range(_u32(b))]
    evals_beta2 = [[_fr(b) for _ in range(_u32(b))] for _ in range(_u32(b))]
    openings = [(_g1(b), _fr(b)) for _ in range(2)]
    if b.read(1):
        raise ProofBytesError("bytes after the proof")
    return Proof(comms, g2, g2s, h2, sigmas, evals_beta1, evals_beta2,
                 openings)


def _w_g1(out: List[bytes], p: Point) -> None:
    if p is None:
        raw = bytearray(48)
        raw[-1] |= INF_FLAG
    else:
        raw = bytearray(p[0].to_bytes(48, "little"))
        if _y_is_neg(p[1]):
            raw[-1] |= NEG_FLAG
    out.append(bytes(raw))


def serialize(p: Proof) -> bytes:
    """The canonical bytes of a parsed proof: parse(serialize(p)) == p and
    serialize(parse(data)) == data for every canonical encoding."""
    out = [MAGIC, struct.pack("<I", VERSION)]
    fr = lambda v: out.append(v.to_bytes(32, "little"))  # noqa: E731
    u32 = lambda v: out.append(struct.pack("<I", v))  # noqa: E731
    for c in p.comms:
        _w_g1(out, c)
    u32(len(p.comm_g2))
    for g2, g2s, h2, sigma in zip(p.comm_g2, p.comm_g2_shift, p.comm_h2,
                                  p.sigmas):
        _w_g1(out, g2)
        _w_g1(out, g2s)
        _w_g1(out, h2)
        fr(sigma)
    u32(len(p.evals_beta1))
    for v in p.evals_beta1:
        fr(v)
    u32(len(p.evals_beta2))
    for row in p.evals_beta2:
        u32(len(row))
        for v in row:
            fr(v)
    for w, rand in p.openings:
        _w_g1(out, w)
        fr(rand)
    return b"".join(out)
