"""Boolean / byte / word gadget layer with ark-style constant propagation.

TPU-native equivalent of ark-r1cs-std's `Boolean`/`UInt8`/`UInt32` plus
simpleworks' `BitwiseOperationGadget`/`ByteRotationGadget` at the reference's
import sites (src/aes_circuit.rs:4-13, src/helpers/mod.rs:4-7; SURVEY.md §2a).

Key design difference from the reference: gadgets here are *template
compilers*, not value carriers. Each operation either folds constants
(emitting nothing) or allocates a witness bit with one R1CS constraint AND
appends a vectorizable computation record to the WitnessPlan — so witness
values for a proof are produced by the leveled JAX evaluator
(models/witness_plan.py), never by re-running gadget objects
(SURVEY.md §2b ark-relations row: "witness values computed by JAX AES trace,
not by pointer-chasing gadget objects").

A Bool is an affine form  c + q * var  with q in {0, +1, -1}:
    Const(v)   = (v, None, 0)
    Var(i)     = (0, i, +1)
    Not(i)     = (1, i, -1)
mirroring ark's Boolean::{Constant, Is, Not}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..field import R_MOD
from .r1cs import LC, R1CS
from .witness_plan import WitnessPlan

MINUS1 = R_MOD - 1


@dataclass(frozen=True)
class Bool:
    c: int                 # constant part (0 or 1)
    var: Optional[int]     # r1cs variable id (negative = witness temp id)
    q: int                 # coefficient: 0, 1 or -1

    @staticmethod
    def const(v: int) -> "Bool":
        return Bool(v & 1, None, 0)

    @staticmethod
    def from_var(i: int) -> "Bool":
        return Bool(0, i, 1)

    @property
    def is_const(self) -> bool:
        return self.var is None

    def lc(self) -> LC:
        """As an R1CS linear combination (constant rides on variable 0)."""
        out: LC = {}
        if self.c:
            out[0] = self.c % R_MOD
        if self.var is not None and self.q:
            out[self.var] = self.q % R_MOD
        return out

    def negate(self) -> "Bool":
        """Logical NOT — free (ark Boolean::not)."""
        if self.is_const:
            return Bool.const(1 - self.c)
        return Bool(1 - self.c, self.var, -self.q)


def _lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % R_MOD
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def _lc_sub(a: LC, b: LC) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) - v) % R_MOD
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def _lc_scale(a: LC, k: int) -> LC:
    k %= R_MOD
    return {i: v * k % R_MOD for i, v in a.items()} if k else {}


class Synth:
    """Synthesis context: owns the constraint system and the witness plan."""

    def __init__(self) -> None:
        self.cs = R1CS()
        self.plan = WitnessPlan()

    # -- allocation --------------------------------------------------------

    def alloc_input_bit(self, source: str, slot: int) -> Bool:
        """Witness bit whose proof-time value comes from an external input
        tensor (message/key bytes). Booleanity-constrained like ark's
        UInt8::new_witness (src/lib.rs:70-92 allocates 8 Boolean wits/byte)."""
        w = self.cs.new_witness_var()
        self.plan.add_input(w, source, slot)
        b = Bool.from_var(w)
        # a * (1 - a) = 0
        self.cs.enforce(b.lc(), b.negate().lc(), {})
        return b

    def alloc_instance_input_bit(self, source: str, slot: int) -> Bool:
        """Public-input bit valued from an external input tensor (CBC IV)."""
        idx = self.cs.new_instance_var()
        self.plan.add_instance_input(idx, source, slot)
        b = Bool.from_var(idx)
        self.cs.enforce(b.lc(), b.negate().lc(), {})  # booleanity
        return b

    def alloc_instance_bit(self, output_lc_of: Bool) -> Bool:
        """Public-input bit (ciphertext), valued from a computed bit
        (src/lib.rs:282-286: new_input then enforce_equal)."""
        idx = self.cs.new_instance_var()
        self.plan.add_instance_output(idx, output_lc_of.c, output_lc_of.var,
                                      output_lc_of.q)
        b = Bool.from_var(idx)
        self.cs.enforce(b.lc(), b.negate().lc(), {})  # booleanity, as new_input
        self.cs.enforce(_lc_sub(b.lc(), output_lc_of.lc()), {0: 1}, {})
        return b

    def _alloc_derived(self, a: Bool, b: Bool, s: Optional[Bool],
                       kind: str) -> Bool:
        """Allocate a derived bit and its evaluation record.

        The evaluation value is expressed as
            out = c0 + c1 x + c2 y + c3 s + c4 xy + c5 sx + c6 sy
        over the raw operand variables (x = a.var, y = b.var, s = sel.var),
        obtained by expanding the boolean formula over affine forms.
        """
        w = self.cs.new_witness_var()
        coeffs = _expand(kind, a, b, s)
        self.plan.add_op(
            w,
            a.var if a.var is not None else 0,
            b.var if b.var is not None else 0,
            (s.var if s is not None and s.var is not None else 0),
            coeffs,
        )
        return Bool.from_var(w)

    # -- boolean ops (ark Boolean semantics) -------------------------------

    def b_xor(self, a: Bool, b: Bool) -> Bool:
        """XOR (ark Boolean::xor): free with a constant or shared variable;
        otherwise one constraint (2a) * b = a + b - w."""
        if a.is_const:
            return b if a.c == 0 else b.negate()
        if b.is_const:
            return a if b.c == 0 else a.negate()
        if a.var == b.var:
            # x^x = 0 ; x^!x = 1
            return Bool.const(0 if a.q == b.q and a.c == b.c else 1)
        w = self._alloc_derived(a, b, None, "xor")
        # (2a) * b = a + b - w  =>  w = a + b - 2ab = a XOR b
        c_lc = _lc_sub(_lc_add(a.lc(), b.lc()), w.lc())
        self.cs.enforce(_lc_scale(a.lc(), 2), b.lc(), c_lc)
        return w

    def b_and(self, a: Bool, b: Bool) -> Bool:
        """AND (ark Boolean::and): a * b = w."""
        if a.is_const:
            return Bool.const(0) if a.c == 0 else b
        if b.is_const:
            return Bool.const(0) if b.c == 0 else a
        if a.var == b.var:
            same = a.q == b.q and a.c == b.c
            return a if same else Bool.const(0)
        w = self._alloc_derived(a, b, None, "and")
        self.cs.enforce(a.lc(), b.lc(), w.lc())
        return w

    def b_or(self, a: Bool, b: Bool) -> Bool:
        """OR (ark Boolean::or): (1-a)(1-b) = 1-w."""
        if a.is_const:
            return Bool.const(1) if a.c == 1 else b
        if b.is_const:
            return Bool.const(1) if b.c == 1 else a
        if a.var == b.var:
            same = a.q == b.q and a.c == b.c
            return a if same else Bool.const(1)
        w = self._alloc_derived(a, b, None, "or")
        self.cs.enforce(a.negate().lc(), b.negate().lc(), w.negate().lc())
        return w

    def b_select(self, s: Bool, t: Bool, f: Bool) -> Bool:
        """s ? t : f (ark CondSelectGadget): s * (t - f) = w - f."""
        if s.is_const:
            return t if s.c == 1 else f
        if t.is_const and f.is_const:
            if t.c == f.c:
                return t
            return s if t.c == 1 else s.negate()
        if (not t.is_const and not f.is_const and t.var == f.var
                and t.q == f.q and t.c == f.c):
            return t
        w = self._alloc_derived(t, f, s, "select")
        self.cs.enforce(s.lc(), _lc_sub(t.lc(), f.lc()), _lc_sub(w.lc(), f.lc()))
        return w

    def enforce_equal(self, a: Bool, b: Bool) -> None:
        """(a - b) * 1 = 0 (ark EqGadget::enforce_equal per bit)."""
        self.cs.enforce(_lc_sub(a.lc(), b.lc()), {0: 1}, {})


def _expand(kind: str, a: Bool, b: Bool, s: Optional[Bool]) -> Tuple[int, ...]:
    """Expand the boolean formula over affine operand forms into the 7-term
    evaluation basis (1, x, y, s, xy, sx, sy), coefficients mod r."""
    # represent each operand as poly over monomials 1, x / 1, y / 1, s
    ca, qa = a.c, (a.q if a.var is not None else 0)
    cb, qb = b.c, (b.q if b.var is not None else 0)
    # target monomial order: (c0, x, y, s, xy, sx, sy)
    out = [0] * 7
    def add(i: int, v: int) -> None:
        out[i] = (out[i] + v) % R_MOD

    if kind == "xor":  # w = a + b - 2ab
        add(0, ca + cb - 2 * ca * cb)
        add(1, qa - 2 * qa * cb)
        add(2, qb - 2 * ca * qb)
        add(4, -2 * qa * qb)
    elif kind == "and":  # w = ab
        add(0, ca * cb)
        add(1, qa * cb)
        add(2, ca * qb)
        add(4, qa * qb)
    elif kind == "or":  # w = a + b - ab
        add(0, ca + cb - ca * cb)
        add(1, qa - qa * cb)
        add(2, qb - ca * qb)
        add(4, -qa * qb)
    elif kind == "select":  # w = f + s(t - f); t->(x), f->(y), s->(s)
        assert s is not None
        cs_, qs = s.c, (s.q if s.var is not None else 0)
        # f part
        add(0, cb)
        add(2, qb)
        # s * (t - f) with t = ca + qa x, f = cb + qb y, s = cs_ + qs s
        dc = ca - cb
        add(0, cs_ * dc)
        add(1, cs_ * qa)
        add(2, -cs_ * qb)
        add(3, qs * dc)
        add(5, qs * qa)
        add(6, -qs * qb)
    else:  # pragma: no cover
        raise ValueError(kind)
    return tuple(v % R_MOD for v in out)


# ---------------------------------------------------------------------------
# Byte and word gadgets (bit vectors, LSB-first like ark to_bits_le)
# ---------------------------------------------------------------------------

Byte = Tuple[Bool, ...]   # 8 bits, LSB first
Word = Tuple[Bool, ...]   # 32 bits, LSB first


def byte_const(v: int) -> Byte:
    return tuple(Bool.const((v >> i) & 1) for i in range(8))


def byte_xor(sy: Synth, a: Byte, b: Byte) -> Byte:
    """UInt8::xor — bitwise (src/aes_circuit.rs:214-241 add_round_key)."""
    return tuple(sy.b_xor(x, y) for x, y in zip(a, b))


def byte_shift_left(a: Byte, k: int) -> Byte:
    """UInt8 shift_left by k: wire permutation, zero-fill low bits — free
    (simpleworks BitwiseOperationGadget::shift_left, call site
    src/aes_circuit.rs:378)."""
    return tuple(Bool.const(0) if i < k else a[i - k] for i in range(8))


def byte_shift_right(a: Byte, k: int) -> Byte:
    """UInt8 shift_right by k (src/aes_circuit.rs:369)."""
    return tuple(a[i + k] if i + k < 8 else Bool.const(0) for i in range(8))


def word_xor(sy: Synth, a: Word, b: Word) -> Word:
    return tuple(sy.b_xor(x, y) for x, y in zip(a, b))


def word_const(v: int) -> Word:
    return tuple(Bool.const((v >> i) & 1) for i in range(32))


def bytes_to_word(bts: Sequence[Byte]) -> Word:
    """to_u32: 4 bytes big-endian-first into a 32-bit word
    (src/aes_circuit.rs:200-212: value[0] is the most significant byte)."""
    assert len(bts) == 4
    bits: List[Bool] = []
    for j in range(3, -1, -1):  # least significant byte is bts[3]
        bits.extend(bts[j])
    return tuple(bits)


def word_to_bytes(w: Word) -> List[Byte]:
    """to_bytes_be (src/aes_circuit.rs:188-198)."""
    out: List[Byte] = []
    for j in range(3, -1, -1):
        out.append(tuple(w[8 * j : 8 * j + 8]))
    return out
