"""AES-128 (FIPS-197), byte by byte: the reference's own cipher.

The S-box is worked out from its definition (the inverse in GF(2^8), then
the affine map), not copied from a table, so that the ciphertext a proof
is judged against owes nothing to the program's constants.
"""

from __future__ import annotations

from typing import List, Tuple


def _gmul(a: int, b: int) -> int:
    """Product in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ (0x1B if a & 0x80 else 0)) & 0xFF
        b >>= 1
    return out


def _sbox() -> Tuple[int, ...]:
    out = []
    for x in range(256):
        inv = 0
        if x:
            inv = 1
            for _ in range(254):             # x^254 = x^-1
                inv = _gmul(inv, x)
        b = inv
        s = b
        for k in range(1, 5):
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        out.append(s ^ 0x63)
    return tuple(out)


SBOX = _sbox()
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def round_keys(key: bytes) -> List[List[int]]:
    """The 11 round keys of a 16-byte key, 16 bytes each."""
    if len(key) != 16:
        raise ValueError("AES-128 takes a 16-byte key")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(11)]


def _mix(col: List[int]) -> List[int]:
    a0, a1, a2, a3 = col
    return [_gmul(a0, 2) ^ _gmul(a1, 3) ^ a2 ^ a3,
            a0 ^ _gmul(a1, 2) ^ _gmul(a2, 3) ^ a3,
            a0 ^ a1 ^ _gmul(a2, 2) ^ _gmul(a3, 3),
            _gmul(a0, 3) ^ a1 ^ a2 ^ _gmul(a3, 2)]


def encrypt_block(block: bytes, keys: List[List[int]]) -> bytes:
    """One 16-byte block; the state is column-major (byte 4c + r is row r
    of column c)."""
    s = [b ^ k for b, k in zip(block, keys[0])]
    for rnd in range(1, 11):
        s = [SBOX[b] for b in s]
        s = [s[4 * ((c + r) % 4) + r] for c in range(4) for r in range(4)]
        if rnd < 10:
            s = sum((_mix(s[4 * c:4 * c + 4]) for c in range(4)), [])
        s = [b ^ k for b, k in zip(s, keys[rnd])]
    return bytes(s)


def encrypt_ecb(message: bytes, key: bytes) -> bytes:
    if not message or len(message) % 16:
        raise ValueError("ECB takes a positive multiple of 16 bytes")
    keys = round_keys(key)
    return b"".join(encrypt_block(message[i:i + 16], keys)
                    for i in range(0, len(message), 16))


def bits_lsb_first(data: bytes) -> List[int]:
    """Each byte's bits, least significant first: the circuit's public
    input order."""
    return [(b >> i) & 1 for b in data for i in range(8)]
