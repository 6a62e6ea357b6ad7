"""A Plonk proof's bytes: read and written by the format's own rules.

Layout (`ZKAESPLK`, version 1): the magic b"ZKAESPLK", a u32 version
(little-endian), then the seven commitments comm_a, comm_b, comm_c,
comm_z, t_lo, t_mid, t_hi; the six evaluations eval_a, eval_b, eval_c,
eval_s1, eval_s2, eval_zw; the two opening witnesses w_zeta and
w_zeta_omega. Nothing else: no counts, and no bytes after the last
point. A G1 point is ark-serialize 0.3's compressed form and an Fr value
32 bytes little-endian, both by Marlin's codec (`..proof`): a point must
lie on the curve and in the order-r subgroup, an Fr value below r;
anything else is refused. 9 points and 6 values: 12 + 9 * 48 + 6 * 32 =
636 bytes.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import List

from ..field import Point
from ..proof import ProofBytesError, _fr, _g1, _read, _u32, _w_g1

MAGIC = b"ZKAESPLK"
VERSION = 1
SIZE = 12 + 9 * 48 + 6 * 32

__all__ = ["MAGIC", "VERSION", "SIZE", "PlonkProof", "ProofBytesError",
           "parse", "serialize"]


@dataclass
class PlonkProof:
    comm_a: Point
    comm_b: Point
    comm_c: Point
    comm_z: Point
    comm_t: List[Point]          # t_lo, t_mid, t_hi
    eval_a: int
    eval_b: int
    eval_c: int
    eval_s1: int
    eval_s2: int
    eval_zw: int
    w_zeta: Point
    w_zeta_omega: Point


def parse(data: bytes) -> PlonkProof:
    b = io.BytesIO(data)
    if _read(b, 8) != MAGIC:
        raise ProofBytesError("bad magic")
    if _u32(b) != VERSION:
        raise ProofBytesError("unsupported version")
    comm_a, comm_b, comm_c, comm_z = (_g1(b) for _ in range(4))
    comm_t = [_g1(b) for _ in range(3)]
    evals = [_fr(b) for _ in range(6)]
    w_zeta, w_zeta_omega = _g1(b), _g1(b)
    if b.read(1):
        raise ProofBytesError("bytes after the proof")
    return PlonkProof(comm_a, comm_b, comm_c, comm_z, comm_t, *evals,
                      w_zeta, w_zeta_omega)


def serialize(p: PlonkProof) -> bytes:
    """The canonical bytes of a parsed proof: serialize(parse(data)) ==
    data for every canonical encoding."""
    out = [MAGIC, struct.pack("<I", VERSION)]
    for c in [p.comm_a, p.comm_b, p.comm_c, p.comm_z] + list(p.comm_t):
        _w_g1(out, c)
    for v in (p.eval_a, p.eval_b, p.eval_c, p.eval_s1, p.eval_s2,
              p.eval_zw):
        out.append(v.to_bytes(32, "little"))
    _w_g1(out, p.w_zeta)
    _w_g1(out, p.w_zeta_omega)
    return b"".join(out)
