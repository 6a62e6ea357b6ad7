"""The Fiat-Shamir transcript of the proof format, byte for byte.

A copy of the port's `utils/transcript.py` with points as affine pairs:
a running blake2s state absorbs length-prefixed labelled items, and each
Fr challenge is a counter-mode hash reduced mod r.
"""

from __future__ import annotations

import hashlib
import struct

from .field import Q_MOD, R_MOD


class Transcript:
    def __init__(self, domain_sep: bytes = b"zkaes-tpu-marlin-v1"):
        self._state = hashlib.blake2s(domain_sep).digest()
        self._counter = 0

    def absorb_bytes(self, label: bytes, data: bytes) -> None:
        h = hashlib.blake2s(self._state)
        h.update(struct.pack("<I", len(label)) + label
                 + struct.pack("<Q", len(data)) + data)
        self._state = h.digest()
        self._counter = 0

    def absorb_u64(self, label: bytes, value: int) -> None:
        self.absorb_bytes(label, struct.pack("<Q", value))

    def absorb_fr(self, label: bytes, value: int) -> None:
        self.absorb_bytes(label, int(value % R_MOD).to_bytes(32, "little"))

    def absorb_fr_list(self, label: bytes, values) -> None:
        self.absorb_bytes(label, b"".join(
            int(v % R_MOD).to_bytes(32, "little") for v in values))

    def absorb_g1(self, label: bytes, point) -> None:
        if point is None:
            self.absorb_bytes(label, b"\x00" * 97)
        else:
            self.absorb_bytes(label, b"\x01"
                              + (point[0] % Q_MOD).to_bytes(48, "little")
                              + (point[1] % Q_MOD).to_bytes(48, "little"))

    def challenge_fr(self, label: bytes) -> int:
        h = hashlib.blake2s(self._state)
        h.update(b"challenge" + struct.pack("<I", len(label)) + label)
        h.update(struct.pack("<Q", self._counter))
        self._counter += 1
        return int.from_bytes(h.digest(), "little") % R_MOD
