"""AES-128 as a Plonk circuit (the reference README's roadmap item).

Maps the same computation the Marlin path proves (reference
src/aes_circuit.rs via models/aes_circuit.py) onto plonk/circuit.py
gates, proving a 16-byte ECB block: private message+key bits, public
ciphertext bits (LSB-first per byte — the api.py / helpers/mod.rs:84-93
convention), tamper-rejecting.

Gate budget (one 16-byte block, full 10 rounds, 200 S-boxes):

  * S-box: an indicator-product mux instead of the R1CS path's
    conditional-select tree — build the 256 byte-value indicator wires
    ind_v = prod_i (s_i if v_i else 1-s_i) as a pair/quad/byte product
    tree (304 bilinear gates), then each output bit is the sum of the
    ~128 indicators whose table bit is set (~127 binary-add gates x 8).
    ~1320 gates per S-box vs ~4100 for a wired select tree.
  * xor: ONE gate (z = x + y - 2xy as q_L/q_R/q_M/q_O), unlike
    circuit.xor_bits' 3-gate demo form.
  * xtime (GF(2^8) doubling): wire shift + 3 xors with the high bit
    (0x1b taps), matching aes_circuit's gmix doubling.

Total ~272k gates -> domain 2^19, well inside the d=2^20 KZG SRS.

The builder records a value trace alongside the gates, so per-proof
witness assignment is a linear replay (the Plonk analog of
models/witness_plan.py's "synthesize once, fill per proof").
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from ..ops.aes_host import SBOX, RCON
from ..ops.field_params import R_MOD
from ..utils.errors import InvalidInputError, require
from .circuit import SMALL, PlonkCircuit

# trace op kinds
_IN = 0        # (src, index)            src: 0=message 1=key
_BILIN = 1     # (x, y, qm, ql, qr, qc)  out = qm*x*y + ql*x + qr*y + qc
_ADD2 = 2      # (x, y, cx, cy)          out = cx*x + cy*y


class AesPlonkCircuit:
    """AES-128-ECB single-block Plonk circuit + witness replay trace."""

    def __init__(self, build: bool = True) -> None:
        self.circuit = PlonkCircuit()
        self.trace: List[Tuple[int, tuple]] = []   # (var, (kind, ...))
        self._levels = None     # (trace length, inputs, levels): _plan
        if build:
            self._build()   # tests use build=False for piece-level checks

    # -- gate/trace helpers -------------------------------------------------

    def _input(self, src: int, idx: int) -> int:
        v = self.circuit.var()
        self.trace.append((v, (_IN, src, idx)))
        self.circuit.assert_bool(v)
        return v

    def _bilin(self, x: int, y: int, qm: int, ql: int, qr: int,
               qc: int) -> int:
        """out = qm*x*y + ql*x + qr*y + qc (one gate)."""
        out = self.circuit.var()
        self.trace.append((out, (_BILIN, x, y, qm, ql, qr, qc)))
        self.circuit.gate(ql, qr, -1, qm, qc, x, y, out)
        return out

    def _add2(self, x: int, y: int, cx: int = 1, cy: int = 1) -> int:
        out = self.circuit.var()
        self.trace.append((out, (_ADD2, x, y, cx, cy)))
        self.circuit.gate(cx, cy, -1, 0, 0, x, y, out)
        return out

    def _xor(self, x: int, y: int) -> int:
        """z = x + y - 2xy (booleans)."""
        return self._bilin(x, y, -2, 1, 1, 0)

    def _xor_bytes(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        return [self._xor(x, y) for x, y in zip(a, b)]

    # -- AES pieces (bytes = 8 wire ids, LSB first) ------------------------

    def _sbox(self, bits: Sequence[int]) -> List[int]:
        c = self
        # pair indicators for (s0,s1), (s2,s3), (s4,s5), (s6,s7):
        # ind[v] over 2 bits: (1-x)(1-y), x(1-y), (1-x)y, xy
        pair_inds = []
        for i in range(0, 8, 2):
            x, y = bits[i], bits[i + 1]
            pair_inds.append([
                c._bilin(x, y, 1, -1, -1, 1),
                c._bilin(x, y, -1, 1, 0, 0),
                c._bilin(x, y, -1, 0, 1, 0),
                c._bilin(x, y, 1, 0, 0, 0),
            ])
        # quad indicators (bits 0-3 and 4-7): 16 products each
        quads = []
        for q in range(2):
            lo, hi = pair_inds[2 * q], pair_inds[2 * q + 1]
            quads.append([
                c._bilin(lo[v & 3], hi[v >> 2], 1, 0, 0, 0)
                for v in range(16)
            ])
        # byte indicators: 256 products
        ind = [c._bilin(quads[0][v & 15], quads[1][v >> 4], 1, 0, 0, 0)
               for v in range(256)]
        # output bits: tree-sum of the set indicators
        out = []
        for j in range(8):
            terms = [ind[v] for v in range(256) if (SBOX[v] >> j) & 1]
            while len(terms) > 1:
                nxt = [c._add2(terms[i], terms[i + 1])
                       for i in range(0, len(terms) - 1, 2)]
                if len(terms) % 2:
                    nxt.append(terms[-1])
                terms = nxt
            out.append(terms[0])
        return out

    def _xtime(self, b: Sequence[int]) -> List[int]:
        """GF(2^8) doubling: (b << 1) xor (0x1b if high bit)."""
        msb = b[7]
        out = [msb]                                   # 0x1b bit 0
        for i in range(1, 8):
            prev = b[i - 1]
            if (0x1B >> i) & 1:                       # bits 1, 3, 4
                out.append(self._xor(prev, msb))
            else:
                out.append(prev)
        return out

    def _gmix_column(self, col: List[List[int]]) -> List[List[int]]:
        """MixColumns on one 4-byte column (aes_circuit.rs gmix_column
        semantics: out_i = 2*a_i ^ 3*a_{i+1} ^ a_{i+2} ^ a_{i+3})."""
        out = []
        for i in range(4):
            a0, a1 = col[i], col[(i + 1) % 4]
            a2, a3 = col[(i + 2) % 4], col[(i + 3) % 4]
            d0 = self._xtime(a0)
            t1 = self._xor_bytes(self._xtime(a1), a1)  # 3*a1
            acc = self._xor_bytes(d0, t1)
            acc = self._xor_bytes(acc, a2)
            out.append(self._xor_bytes(acc, a3))
        return out

    # -- full circuit ------------------------------------------------------

    def _build(self) -> None:
        c = self.circuit
        # public: 128 ciphertext bits, LSB-first per byte (api.py order)
        self.ct_pub = [c.public_input() for _ in range(128)]
        # private inputs
        msg = [[self._input(0, 8 * byte + bit) for bit in range(8)]
               for byte in range(16)]
        key = [[self._input(1, 8 * byte + bit) for bit in range(8)]
               for byte in range(16)]

        # key schedule: 44 words of 4 bytes (aes_circuit.rs derive_keys)
        words: List[List[List[int]]] = [
            [key[4 * w + i] for i in range(4)] for w in range(4)
        ]
        for w in range(4, 44):
            prev = words[w - 1]
            if w % 4 == 0:
                rot = [prev[1], prev[2], prev[3], prev[0]]
                sub = [self._sbox(b) for b in rot]
                rc = RCON[w // 4 - 1]
                # round constant folds into byte 0's xor gates: where the
                # rc bit is set, (x ^ y) ^ 1 is one bilinear gate too
                first = [
                    self._rcon_xor(sub[0][bit], words[w - 4][0][bit])
                    if (rc >> bit) & 1
                    else self._xor(sub[0][bit], words[w - 4][0][bit])
                    for bit in range(8)
                ]
                rest = [self._xor_bytes(sub[i], words[w - 4][i])
                        for i in range(1, 4)]
                words.append([first] + rest)
            else:
                words.append([
                    self._xor_bytes(prev[i], words[w - 4][i])
                    for i in range(4)
                ])

        round_keys = [
            [words[4 * r + (i // 4)][i % 4] for i in range(16)]
            for r in range(11)
        ]

        state = [self._xor_bytes(msg[i], round_keys[0][i])
                 for i in range(16)]
        for rnd in range(1, 11):
            state = [self._sbox(b) for b in state]
            # shift_rows: state laid out column-major (byte i = column
            # i//4, row i%4) — pure rewiring (aes_circuit.rs:268-334)
            state = [state[(i + 4 * (i % 4)) % 16] for i in range(16)]
            if rnd < 10:
                mixed = []
                for col in range(4):
                    mixed.extend(
                        self._gmix_column(state[4 * col:4 * col + 4]))
                state = mixed
            state = [self._xor_bytes(state[i], round_keys[rnd][i])
                     for i in range(16)]

        # bind computed ciphertext bits to the public inputs
        for byte in range(16):
            for bit in range(8):
                c.assert_equal(self.ct_pub[8 * byte + bit],
                               state[byte][bit])

    def _rcon_xor(self, x: int, y: int) -> int:
        """(x ^ y) ^ 1 = 1 - (x + y - 2xy) = 2xy - x - y + 1."""
        return self._bilin(x, y, 2, -1, -1, 1)

    # -- witness -----------------------------------------------------------

    def assign(self, message: bytes, key: bytes) -> Dict[int, int]:
        """Replay the value trace for one (message, key)."""
        require(len(message) == 16, InvalidInputError,
                "plonk AES proves one 16-byte block")
        require(len(key) == 16, InvalidInputError, "key must be 16 bytes")
        mbits = [(message[i // 8] >> (i % 8)) & 1 for i in range(128)]
        kbits = [(key[i // 8] >> (i % 8)) & 1 for i in range(128)]
        vals: Dict[int, int] = {0: 0}
        for var, op in self.trace:
            kind = op[0]
            if kind == _IN:
                vals[var] = (mbits if op[1] == 0 else kbits)[op[2]]
            elif kind == _BILIN:
                _, x, y, qm, ql, qr, qc = op
                vx, vy = vals[x], vals[y]
                vals[var] = (qm * vx * vy + ql * vx + qr * vy + qc) % R_MOD
            else:
                _, x, y, cx, cy = op
                vals[var] = (cx * vals[x] + cy * vals[y]) % R_MOD
        return vals

    def assign_dense(self, message: bytes, key: bytes
                     ) -> Union[np.ndarray, Dict[int, int]]:
        """`assign` as a dense int64 array indexed by variable id (0 where
        the trace sets nothing: var 0 and the public inputs), replayed a
        level of the trace at a time with numpy. int64 is exact while every
        value lies in [0, SMALL) and every coefficient within SMALL of 0
        (each term stays below 2^60), which each level checks; where one
        does not hold, `assign`'s dict."""
        require(len(message) == 16, InvalidInputError,
                "plonk AES proves one 16-byte block")
        require(len(key) == 16, InvalidInputError, "key must be 16 bytes")
        plan = self._plan()
        if plan is None:
            return self.assign(message, key)
        inputs, levels = plan
        bits = np.unpackbits(np.frombuffer(bytes(message) + bytes(key),
                                           np.uint8), bitorder="little")
        z = np.zeros(self.circuit.num_vars, np.int64)
        z[inputs[0]] = bits[inputs[1]]
        for out, x, y, qm, ql, qr, qc in levels:
            vx, vy = z[x], z[y]
            v = qm * vx * vy + ql * vx + qr * vy + qc
            if v.size and (v.min() < 0 or v.max() >= SMALL):
                return self.assign(message, key)
            z[out] = v
        return z

    def _plan(self):
        """(inputs, levels) of the trace for `assign_dense`, built once:
        inputs = (var ids, bit index into message bits then key bits);
        each level the ops whose operands are all set by earlier levels,
        as int64 arrays (out, x, y, qm, ql, qr, qc), an _ADD2 op as
        qm = qc = 0. None where a coefficient lies SMALL or more from 0."""
        if self._levels is not None and self._levels[0] == len(self.trace):
            return self._levels[1]
        depth = {0: 0}
        inputs: Tuple[List[int], List[int]] = ([], [])
        rows: Dict[int, List[tuple]] = {}
        for var, op in self.trace:
            if op[0] == _IN:
                depth[var] = 0
                inputs[0].append(var)
                inputs[1].append(128 * op[1] + op[2])
                continue
            if op[0] == _BILIN:
                _, x, y, qm, ql, qr, qc = op
            else:
                (_, x, y, ql, qr), qm, qc = op, 0, 0
            d = 1 + max(depth[x], depth[y])
            depth[var] = d
            rows.setdefault(d, []).append((var, x, y, qm, ql, qr, qc))
        plan = None
        coeffs = [c for ops in rows.values() for row in ops for c in row[3:]]
        if all(-SMALL < c < SMALL for c in coeffs):
            plan = (tuple(np.asarray(col, np.int64) for col in inputs),
                    [tuple(np.asarray(col, np.int64) for col in zip(*rows[d]))
                     for d in sorted(rows)])
        self._levels = (len(self.trace), plan)
        return plan

    @staticmethod
    def public_values(ciphertext: bytes) -> List[int]:
        require(len(ciphertext) == 16, InvalidInputError,
                "ciphertext must be 16 bytes")
        return [(ciphertext[i // 8] >> (i % 8)) & 1 for i in range(128)]
