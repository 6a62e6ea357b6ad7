"""Plonk circuit builder: gates + copy constraints.

The reference's README roadmap lists a Plonk backend as future work
(reference README.md:5; BASELINE config #5); nothing exists in the Rust
repo to port, so this is designed directly against the Plonk paper
(GWC19, "PlonK: Permutations over Lagrange-bases for Oecumenical
Noninteractive arguments of Knowledge").

Arithmetization: each gate row enforces

    q_L*a + q_R*b + q_O*c + q_M*a*b + q_C + PI_i = 0

over wire values (a, b, c); wires that carry the same circuit variable
are linked by the copy-constraint permutation sigma over the 3*N wire
slots. Public inputs occupy the first `num_public` rows (q_L = 1, the
input value supplied through PI(X) = sum -x_i L_i(X)).

The builder compiles to a static table (selector columns + sigma slot
permutation) exactly like models/r1cs.py compiles the AES circuit to a
static CSR template: circuit shape is input-independent, witness values
are filled per proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.field_params import R_MOD, fr_multiplicative_generator, root_of_unity
from ..utils.errors import ZkAesError, require

# wire values in [0, SMALL) and selectors within SMALL of 0 keep every term
# of a gate's equation, and their sum, far inside int64: the sum is then 0
# exactly when it is 0 mod r
SMALL = 1 << 20


@dataclass
class Gate:
    ql: int
    qr: int
    qo: int
    qm: int
    qc: int
    a: int  # wire variable ids
    b: int
    c: int


class PlonkCircuit:
    """Gate-level circuit builder.

    Variable 0 is the designated zero variable (constrained to 0 by the
    first non-public gate); unused wire slots reference it so every slot
    participates in the permutation argument.
    """

    def __init__(self) -> None:
        self.num_vars = 1  # var 0 == zero
        self.gates: List[Gate] = []
        self.public_vars: List[int] = []
        self._compiled: Optional["PlonkCircuitData"] = None
        self._table = None      # (data, wire var ids, signed selectors)

    # -- variables ---------------------------------------------------------

    def var(self) -> int:
        v = self.num_vars
        self.num_vars += 1
        return v

    def public_input(self) -> int:
        require(not self.gates, ZkAesError,
                "declare public inputs before adding gates")
        v = self.var()
        self.public_vars.append(v)
        return v

    # -- gates -------------------------------------------------------------

    def gate(self, ql: int, qr: int, qo: int, qm: int, qc: int,
             a: int, b: int, c: int) -> None:
        self._compiled = None
        self.gates.append(Gate(ql % R_MOD, qr % R_MOD, qo % R_MOD,
                               qm % R_MOD, qc % R_MOD, a, b, c))

    def add(self, x: int, y: int) -> int:
        """z = x + y."""
        z = self.var()
        self.gate(1, 1, -1, 0, 0, x, y, z)
        return z

    def mul(self, x: int, y: int) -> int:
        """z = x * y."""
        z = self.var()
        self.gate(0, 0, -1, 1, 0, x, y, z)
        return z

    def add_const(self, x: int, k: int) -> int:
        """z = x + k."""
        z = self.var()
        self.gate(1, 0, -1, 0, k, x, 0, z)
        return z

    def mul_const(self, x: int, k: int) -> int:
        """z = k * x."""
        z = self.var()
        self.gate(k, 0, -1, 0, 0, x, 0, z)
        return z

    def assert_equal(self, x: int, y: int) -> None:
        self.gate(1, -1, 0, 0, 0, x, y, 0)

    def assert_bool(self, x: int) -> None:
        """x * x == x."""
        self.gate(-1, 0, 0, 1, 0, x, x, 0)

    def xor_bits(self, x: int, y: int) -> int:
        """z = x XOR y for boolean wires: z = x + y - 2xy (reference demo
        semantics, src/ops.rs:8-18, via the identity over {0,1})."""
        t = self.mul(x, y)
        s = self.add(x, y)
        z = self.var()
        self.gate(1, -2, -1, 0, 0, s, t, z)
        return z

    # -- compile -----------------------------------------------------------

    def compile(self) -> "PlonkCircuitData":
        if self._compiled is not None:
            return self._compiled
        ell = len(self.public_vars)
        rows: List[Gate] = []
        # public-input rows first: q_L*a + PI = a - x = 0
        for v in self.public_vars:
            rows.append(Gate(1, 0, 0, 0, 0, v, 0, 0))
        # pin the zero variable: 1*var0 = 0
        rows.append(Gate(1, 0, 0, 0, 0, 0, 0, 0))
        rows.extend(self.gates)

        n = 1
        log_n = 0
        while n < len(rows):
            n <<= 1
            log_n += 1
        while len(rows) < n:
            rows.append(Gate(0, 0, 0, 0, 0, 0, 0, 0))

        # copy-constraint permutation over slots (col * n + row)
        occurrences: Dict[int, List[int]] = {}
        for j, g in enumerate(rows):
            for col, v in enumerate((g.a, g.b, g.c)):
                occurrences.setdefault(v, []).append(col * n + j)
        sigma = list(range(3 * n))
        for slots in occurrences.values():
            for i, s in enumerate(slots):
                sigma[s] = slots[(i + 1) % len(slots)]

        omega = root_of_unity(log_n)
        g = fr_multiplicative_generator()
        ks = (1, g, g * g % R_MOD)  # disjoint coset representatives
        omega_pows = [1] * n
        for j in range(1, n):
            omega_pows[j] = omega_pows[j - 1] * omega % R_MOD

        def slot_id(slot: int) -> int:
            return ks[slot // n] * omega_pows[slot % n] % R_MOD

        s_sigma = [[slot_id(sigma[col * n + j]) for j in range(n)]
                   for col in range(3)]

        self._compiled = PlonkCircuitData(
            n=n, log_n=log_n, omega=omega, ks=ks,
            num_public=ell, rows=rows, sigma=sigma,
            s_sigma_evals=s_sigma,
            selector_evals=[
                [g.ql for g in rows], [g.qr for g in rows],
                [g.qo for g in rows], [g.qm for g in rows],
                [g.qc for g in rows],
            ],
        )
        return self._compiled

    # -- witness -----------------------------------------------------------

    def wire_columns(
        self, assignment: Dict[int, int], public_values: Sequence[int]
    ) -> Tuple[List[int], List[int], List[int]]:
        """Fill the three wire columns from a variable assignment.

        assignment maps var id -> value; var 0 and public vars are filled
        automatically. Raises if a gate equation is unsatisfied (the same
        eager check ark-relations' is_satisfied gives the reference)."""
        return tuple(c.tolist()
                     for c in self.wire_arrays(assignment, public_values))

    def wire_arrays(self, assignment, public_values: Sequence[int]
                    ) -> tuple:
        """`wire_columns` as three arrays, of `assignment` as a dict or as a
        dense array indexed by variable id. Where every value is small and
        every selector near 0 (a boolean circuit's, the AES circuit's) the
        columns are gathered and the equations checked on int64 arrays,
        where int64 is exact; else gate by gate, and a column whose values
        do not all fit int64 holds Python ints (dtype object)."""
        data = self.compile()
        require(len(public_values) == data.num_public, ZkAesError,
                "public input count mismatch")
        public = [x % R_MOD for x in public_values]
        small = self._small_columns(data, assignment, public)
        if small is not None:
            return small
        if isinstance(assignment, np.ndarray):
            assignment = dict(enumerate(assignment.tolist()))
        full = dict(assignment)
        full[0] = 0
        full.update(zip(self.public_vars, public))
        cols: Tuple[List[int], List[int], List[int]] = ([], [], [])
        for j, g in enumerate(data.rows):
            va, vb, vc = (full.get(g.a, 0), full.get(g.b, 0),
                          full.get(g.c, 0))
            pi = -public_values[j] % R_MOD if j < data.num_public else 0
            lhs = (g.ql * va + g.qr * vb + g.qo * vc
                   + g.qm * va * vb + g.qc + pi) % R_MOD
            require(lhs == 0, ZkAesError,
                    f"gate {j} unsatisfied by witness")
            cols[0].append(va % R_MOD)
            cols[1].append(vb % R_MOD)
            cols[2].append(vc % R_MOD)
        return tuple(_array(c) for c in cols)

    def _gate_table(self, data: "PlonkCircuitData"):
        """(wire var ids, signed selectors) of the compiled rows as int64
        arrays, the selectors None where one lies SMALL or more from 0."""
        if self._table is None or self._table[0] is not data:
            wires = tuple(np.fromiter((getattr(g, w) for g in data.rows),
                                      np.int64, data.n) for w in "abc")
            signed = [[v - R_MOD if v > R_MOD // 2 else v for v in col]
                      for col in data.selector_evals]
            sel = None
            if all(-SMALL < v < SMALL for col in signed for v in col):
                sel = [np.asarray(col, np.int64) for col in signed]
            self._table = (data, wires, sel)
        return self._table[1:]

    def _small_columns(self, data: "PlonkCircuitData", assignment,
                       public: List[int]):
        """The wire columns as int64 arrays where every value of
        `assignment` (a dict, or an int64 array of one value a variable)
        and `public` (reduced) lies in [0, SMALL) and the selectors within
        SMALL of 0; else None."""
        wires, sel = self._gate_table(data)
        if sel is None:
            return None
        try:
            pub = np.fromiter(public, np.int64, len(public))
            if isinstance(assignment, np.ndarray):
                if assignment.dtype != np.int64 or \
                        assignment.shape != (self.num_vars,):
                    return None
                vals = assignment
            else:
                keys = np.fromiter(assignment.keys(), np.int64,
                                   len(assignment))
                vals = np.fromiter(assignment.values(), np.int64,
                                   len(assignment))
        except (OverflowError, TypeError, ValueError):
            return None     # a value too large for int64, or not a number
        if any(x.size and (x.min() < 0 or x.max() >= SMALL)
               for x in (vals, pub)):
            return None
        if isinstance(assignment, np.ndarray):
            z = vals.copy()
        else:
            z = np.zeros(self.num_vars, np.int64)
            keep = (keys >= 0) & (keys < self.num_vars)
            z[keys[keep]] = vals[keep]
        z[0] = 0
        public_vars = np.asarray(self.public_vars, np.int64)
        z[public_vars] = pub
        a, b, c = (z[ids] for ids in wires)
        ql, qr, qo, qm, qc = sel
        lhs = ql * a + qr * b + qo * c + qm * a * b + qc
        lhs[:data.num_public] -= pub
        bad = np.flatnonzero(lhs)
        require(bad.size == 0, ZkAesError,
                f"gate {int(bad[0]) if bad.size else 0} unsatisfied by "
                f"witness")
        return a, b, c


def _array(values: List[int]) -> np.ndarray:
    """`values` as an int64 array where each fits, else as an array of
    Python ints."""
    try:
        return np.asarray(values, np.int64)
    except OverflowError:
        return np.asarray(values, object)


@dataclass
class PlonkCircuitData:
    """Compiled static circuit template (the Plonk preprocessing input)."""

    n: int
    log_n: int
    omega: int
    ks: Tuple[int, int, int]
    num_public: int
    rows: List[Gate]
    sigma: List[int]
    s_sigma_evals: List[List[int]]      # 3 columns of n evals
    selector_evals: List[List[int]]     # qL, qR, qO, qM, qC evals
