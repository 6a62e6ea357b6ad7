"""Blake2s Fiat-Shamir transcript.

The reference's forked ark-marlin derives its challenges with a Blake2s-based
Fiat-Shamir RNG (SURVEY.md §2b: `digest` dep, "Fiat-Shamir via Blake2s").
This stack defines its own byte-level transcript format (documented here and
kept stable for proof (de)serialization compatibility across versions of this
framework): a running blake2s state absorbing length-prefixed labeled items,
squeezing Fr challenges by counter-mode hashing reduced mod r.
"""

from __future__ import annotations

import hashlib
import struct

from ..ops.field_params import Q_MOD, R_MOD


def _fq_bytes(x: int) -> bytes:
    return int(x % Q_MOD).to_bytes(48, "little")


class Transcript:
    """Deterministic labeled transcript over blake2s."""

    def __init__(self, domain_sep: bytes = b"zkaes-tpu-marlin-v1"):
        self._state = hashlib.blake2s(domain_sep).digest()
        self._counter = 0

    def _absorb_raw(self, data: bytes) -> None:
        h = hashlib.blake2s(self._state)
        h.update(data)
        self._state = h.digest()
        self._counter = 0

    def absorb_bytes(self, label: bytes, data: bytes) -> None:
        self._absorb_raw(
            struct.pack("<I", len(label)) + label + struct.pack("<Q", len(data)) + data
        )

    def absorb_u64(self, label: bytes, value: int) -> None:
        self.absorb_bytes(label, struct.pack("<Q", value))

    def absorb_fr(self, label: bytes, value: int) -> None:
        self.absorb_bytes(label, int(value % R_MOD).to_bytes(32, "little"))

    def absorb_fr_list(self, label: bytes, values) -> None:
        data = b"".join(int(v % R_MOD).to_bytes(32, "little") for v in values)
        self.absorb_bytes(label, data)

    def absorb_g1(self, label: bytes, point) -> None:
        """Absorb an affine G1 point (curve_host.AffinePoint over Fq)."""
        if point.inf:
            self.absorb_bytes(label, b"\x00" * 97)
        else:
            self.absorb_bytes(label, b"\x01" + _fq_bytes(point.x) + _fq_bytes(point.y))

    def challenge_fr(self, label: bytes) -> int:
        """Squeeze one Fr challenge (256-bit hash reduced mod r)."""
        h = hashlib.blake2s(self._state)
        h.update(b"challenge" + struct.pack("<I", len(label)) + label)
        h.update(struct.pack("<Q", self._counter))
        self._counter += 1
        return int.from_bytes(h.digest(), "little") % R_MOD

    def challenge_fr_list(self, label: bytes, n: int):
        return [self.challenge_fr(label + b"/%d" % i) for i in range(n)]
