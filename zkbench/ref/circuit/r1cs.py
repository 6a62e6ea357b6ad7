"""Static R1CS constraint system.

TPU-native equivalent of ark-relations' ConstraintSystem at the reference's
call sites (SURVEY.md §2b): because the AES circuit's shape is input-
independent (SURVEY.md §3.3), the system is synthesized ONCE per message
length into index-based sparse matrices; witnesses are filled by the
vectorized trace engine (models/witness_plan.py), not by per-proof gadget
object graphs.

Variable indexing over z = [instance ; witness]:
    z[0] = 1 (the constant-one instance variable, as in ark-relations)
    z[1..num_instance) = public inputs
    z[num_instance..)   = witness
Each constraint row i enforces <A_i, z> * <B_i, z> == <C_i, z>.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..field import R_MOD

# A linear combination: {var_index: coeff mod r}; the constant term rides on
# variable 0 (the one-variable), exactly like ark's LinearCombination.
LC = Dict[int, int]


def lc_const(c: int) -> LC:
    return {0: c % R_MOD} if c % R_MOD else {}


def lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % R_MOD
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def lc_scale(a: LC, k: int) -> LC:
    k %= R_MOD
    if k == 0:
        return {}
    return {i: v * k % R_MOD for i, v in a.items()}


def lc_sub(a: LC, b: LC) -> LC:
    return lc_add(a, lc_scale(b, R_MOD - 1))


@dataclass
class R1CS:
    """A fully-built constraint system (the static template)."""

    num_instance: int = 1  # includes the one-variable
    num_witness: int = 0
    # rows: parallel lists of (A_row, B_row, C_row) linear combinations
    a_rows: List[LC] = field(default_factory=list)
    b_rows: List[LC] = field(default_factory=list)
    c_rows: List[LC] = field(default_factory=list)
    # nonzeros of A, B and C: counted here for the rows given, then added
    # to by enforce (a row never changes once enforced)
    counts: List[int] = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.counts = [sum(len(r) for r in rows)
                       for rows in (self.a_rows, self.b_rows, self.c_rows)]

    # -- construction -------------------------------------------------------

    def new_instance_var(self) -> int:
        """Allocate a public-input variable; returns its z-index."""
        # Instance vars may be allocated at any time (the reference allocates
        # the ciphertext public inputs at the END of synthesis,
        # src/lib.rs:282-286): witnesses carry temporary negative ids until
        # finalized(), so instance indices stay contiguous and low.
        idx = self.num_instance
        self.num_instance += 1
        return idx

    def new_witness_var(self) -> int:
        idx = -(self.num_witness + 1)  # temporary negative id, fixed at finalize
        self.num_witness += 1
        return idx

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        self.a_rows.append(a)
        self.b_rows.append(b)
        self.c_rows.append(c)
        self.counts[0] += len(a)
        self.counts[1] += len(b)
        self.counts[2] += len(c)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_variables(self) -> int:
        return self.num_instance + self.num_witness

    def witness_z_index(self, wit_id: int) -> int:
        """Map a (negative) witness id to its final z index."""
        return self.num_instance + (-wit_id - 1)

    def finalized(self) -> "R1CS":
        """Rewrite temporary negative witness ids into final z indices.

        Witnesses are allocated during synthesis with negative ids so that
        instance variables (the ciphertext bits, allocated at the END of the
        reference circuit, src/lib.rs:282-286) can still receive the low
        indices required by Marlin's input-domain embedding.
        """
        def fix(lc: LC) -> LC:
            return {
                (k if k >= 0 else self.witness_z_index(k)): v for k, v in lc.items()
            }

        return R1CS(
            num_instance=self.num_instance,
            num_witness=self.num_witness,
            a_rows=[fix(r) for r in self.a_rows],
            b_rows=[fix(r) for r in self.b_rows],
            c_rows=[fix(r) for r in self.c_rows],
        )

    # -- inspection / execution --------------------------------------------

    def nnz(self) -> Tuple[int, int, int]:
        """Nonzeros of A, B and C, kept as rows are enforced: the template's
        per-round status log stays linear in the circuit's size."""
        return tuple(self.counts)

    def matrices_coo(self):
        """(rows, cols, vals) int arrays per matrix; vals as Python ints."""
        out = []
        for rows in (self.a_rows, self.b_rows, self.c_rows):
            ri, ci, vi = [], [], []
            for i, row in enumerate(rows):
                for c, v in sorted(row.items()):
                    ri.append(i)
                    ci.append(c)
                    vi.append(v)
            out.append((np.asarray(ri, np.int64), np.asarray(ci, np.int64), vi))
        return out

    def mat_vec(self, rows: List[LC], z: Sequence[int]) -> List[int]:
        return [sum(v * z[k] for k, v in row.items()) % R_MOD for row in rows]

    def is_satisfied(self, z: Sequence[int]) -> bool:
        """Host satisfiability check: Az o Bz == Cz (SURVEY.md §7 step 3)."""
        assert len(z) == self.num_variables
        assert z[0] == 1
        az = self.mat_vec(self.a_rows, z)
        bz = self.mat_vec(self.b_rows, z)
        cz = self.mat_vec(self.c_rows, z)
        return all(a * b % R_MOD == c for a, b, c in zip(az, bz, cz))

    def first_unsatisfied(self, z: Sequence[int]) -> int | None:
        az = self.mat_vec(self.a_rows, z)
        bz = self.mat_vec(self.b_rows, z)
        cz = self.mat_vec(self.c_rows, z)
        for i, (a, b, c) in enumerate(zip(az, bz, cz)):
            if a * b % R_MOD != c:
                return i
        return None

    def stats(self) -> Dict[str, int]:
        """Constraint-system status mirroring the reference's
        debug_constraint_system_status (src/helpers/mod.rs:66-82)."""
        na, nb, nc = self.nnz()
        return {
            "num_constraints": self.num_constraints,
            "num_instance_variables": self.num_instance,
            "num_witness_variables": self.num_witness,
            "num_non_zero": na + nb + nc,
        }
