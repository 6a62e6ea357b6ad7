"""Native AES-128 (ECB) oracle in numpy.

TPU-native equivalent of the reference's plain-u8 AES test oracle
(src/aes.rs, SURVEY.md §2a "Native AES") and of the `aes` crate used by the
example binary (src/main.rs:28-34). Vectorizable over blocks; used as ground
truth by the circuit tests and by bench harnesses.
"""

from __future__ import annotations

import numpy as np

# FIPS-197 S-box — same 256 constants as the reference lookup table
# (src/aes_circuit.rs:433-694).
SBOX = np.array(
    [
        0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B,
        0xFE, 0xD7, 0xAB, 0x76, 0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0,
        0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0, 0xB7, 0xFD, 0x93, 0x26,
        0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
        0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2,
        0xEB, 0x27, 0xB2, 0x75, 0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0,
        0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84, 0x53, 0xD1, 0x00, 0xED,
        0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
        0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F,
        0x50, 0x3C, 0x9F, 0xA8, 0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5,
        0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2, 0xCD, 0x0C, 0x13, 0xEC,
        0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
        0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14,
        0xDE, 0x5E, 0x0B, 0xDB, 0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C,
        0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79, 0xE7, 0xC8, 0x37, 0x6D,
        0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
        0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F,
        0x4B, 0xBD, 0x8B, 0x8A, 0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E,
        0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E, 0xE1, 0xF8, 0x98, 0x11,
        0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
        0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F,
        0xB0, 0x54, 0xBB, 0x16,
    ],
    dtype=np.uint8,
)

RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                dtype=np.uint8)

# shift_rows as a flat gather over the column-major 4x4 state
# (src/aes_circuit.rs:268-334: state[r][c] = bytes[c*4+r], row r rotated by r)
SHIFT_ROWS_IDX = np.array(
    [(((c + r) % 4) * 4 + r) for c in range(4) for r in range(4)], dtype=np.int64
)


def _xtime(b: np.ndarray) -> np.ndarray:
    """GF(2^8) doubling: (b << 1) ^ (0x1B if high bit) — the shift/mask/xor
    chain of src/aes_circuit.rs:360-427 gmix_column."""
    return (((b.astype(np.uint16) << 1) & 0xFF)
            ^ np.where(b & 0x80, 0x1B, 0).astype(np.uint16)).astype(np.uint8)


def derive_round_keys(key: np.ndarray) -> np.ndarray:
    """44-word key schedule -> [11, 16] round keys (src/aes.rs:200-249 /
    src/aes_circuit.rs:20-129)."""
    key = np.asarray(key, np.uint8).reshape(16)
    words = [key[0:4].copy(), key[4:8].copy(), key[8:12].copy(), key[12:16].copy()]
    for i in range(4, 44):
        prev = words[i - 1]
        if i % 4 == 0:
            rot = np.roll(prev, -1)
            sub = SBOX[rot]
            w = words[i - 4] ^ sub ^ np.array([RCON[i // 4 - 1], 0, 0, 0], np.uint8)
        else:
            w = words[i - 4] ^ prev
        words.append(w)
    return np.stack([np.concatenate(words[4 * r : 4 * r + 4]) for r in range(11)])


def mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns over a [..., 16] state, columns of 4 bytes
    (src/aes.rs:152-193)."""
    s = state.reshape(*state.shape[:-1], 4, 4)  # [.., col, row]
    b = _xtime(s)
    a = s
    out = np.empty_like(s)
    out[..., :, 0] = b[..., :, 0] ^ a[..., :, 3] ^ a[..., :, 2] ^ b[..., :, 1] ^ a[..., :, 1]
    out[..., :, 1] = b[..., :, 1] ^ a[..., :, 0] ^ a[..., :, 3] ^ b[..., :, 2] ^ a[..., :, 2]
    out[..., :, 2] = b[..., :, 2] ^ a[..., :, 1] ^ a[..., :, 0] ^ b[..., :, 3] ^ a[..., :, 3]
    out[..., :, 3] = b[..., :, 3] ^ a[..., :, 2] ^ a[..., :, 1] ^ b[..., :, 0] ^ a[..., :, 0]
    return out.reshape(state.shape)


def shift_rows(state: np.ndarray) -> np.ndarray:
    return state[..., SHIFT_ROWS_IDX]


def sub_bytes(state: np.ndarray) -> np.ndarray:
    return SBOX[state]


def encrypt_block_trace(blocks: np.ndarray, round_keys: np.ndarray) -> dict:
    """Encrypt [..., 16] blocks, returning every intermediate state — the
    execution trace the circuit wires carry (SURVEY.md §7 step 2).

    Returns dict with arrays of shape [rounds, ..., 16]:
    start / after_sub / after_shift / after_mix (mix absent for round 10).
    """
    blocks = np.asarray(blocks, np.uint8)
    state = blocks ^ round_keys[0]
    start, asub, ashift, amix = [], [], [], []
    for rnd in range(1, 10):
        start.append(state)
        s1 = sub_bytes(state)
        asub.append(s1)
        s2 = shift_rows(s1)
        ashift.append(s2)
        s3 = mix_columns(s2)
        amix.append(s3)
        state = s3 ^ round_keys[rnd]
    start.append(state)
    s1 = sub_bytes(state)
    asub.append(s1)
    s2 = shift_rows(s1)
    ashift.append(s2)
    state = s2 ^ round_keys[10]
    return {
        "start": np.stack(start),
        "after_sub": np.stack(asub),
        "after_shift": np.stack(ashift),
        "after_mix": np.stack(amix),
        "ciphertext": state,
    }


def encrypt_cbc(message: bytes | np.ndarray, key: bytes | np.ndarray,
                iv: bytes | np.ndarray) -> np.ndarray:
    """AES-128-CBC (the reference's roadmap item,
    tests/integration_tests.rs:1 "should be updated to test CBC")."""
    msg = np.frombuffer(bytes(message), np.uint8) if isinstance(
        message, (bytes, bytearray)) else np.asarray(message, np.uint8)
    assert msg.size % 16 == 0
    rks = derive_round_keys(np.frombuffer(bytes(key), np.uint8) if isinstance(
        key, (bytes, bytearray)) else np.asarray(key, np.uint8))
    prev = np.frombuffer(bytes(iv), np.uint8) if isinstance(
        iv, (bytes, bytearray)) else np.asarray(iv, np.uint8)
    out = []
    for blk in msg.reshape(-1, 16):
        ct = encrypt_block_trace(blk ^ prev, rks)["ciphertext"]
        out.append(ct)
        prev = ct
    return np.concatenate(out)


def encrypt_ecb(message: bytes | np.ndarray, key: bytes | np.ndarray) -> np.ndarray:
    """AES-128-ECB over a multiple-of-16-byte message (src/lib.rs:194
    message.chunks(16))."""
    msg = np.frombuffer(bytes(message), np.uint8) if isinstance(message, (bytes, bytearray)) else np.asarray(message, np.uint8)
    assert msg.size % 16 == 0, "message length must be a multiple of 16"
    rks = derive_round_keys(np.frombuffer(bytes(key), np.uint8) if isinstance(key, (bytes, bytearray)) else np.asarray(key, np.uint8))
    blocks = msg.reshape(-1, 16)
    return encrypt_block_trace(blocks, rks[:, None, :])["ciphertext"].reshape(-1)
