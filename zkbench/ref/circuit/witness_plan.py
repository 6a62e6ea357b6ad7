"""Leveled witness-evaluation plan: the TPU-native witness generator.

The reference recomputes every witness value by re-running ~10^5 gadget
allocations per proof (the dominant synthesis overhead, SURVEY.md §3.2
"circuit synthesis itself ... a real cost in this design"). Here the circuit
template records, for every allocated witness bit, a single fused evaluation
record

    out = c0 + c1 x + c2 y + c3 s + c4 xy + c5 sx + c6 sy        (bits, int32)

over previously-evaluated variables. Records are grouped into topological
LEVELS; proof-time witness generation is then `len(levels)` rounds of
gather -> fused-multiply -> scatter over int32 arrays — one jittable JAX
program with static shapes (compiled once per message length).

All circuit variables are bits, so evaluation runs entirely in int32; the
final witness vector is lifted to Fr only at the z-polynomial boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class _Record:
    out: int           # witness temp id (negative) at build time
    x: int
    y: int
    s: int
    coeffs: Tuple[int, ...]
    level: int


class WitnessPlan:
    def __init__(self) -> None:
        self.records: List[_Record] = []
        # input bits: (witness temp id, source name, flat bit slot)
        self.inputs: List[Tuple[int, str, int]] = []
        # instance outputs: (instance idx, const part, var id or None, q)
        self.instance_outputs: List[Tuple[int, int, Optional[int], int]] = []
        self._levels: Dict[int, int] = {}  # var id -> level (0 for inputs)
        self.compiled: Optional["CompiledPlan"] = None

    # -- build-time API (called by gadgets.Synth) --------------------------

    def add_input(self, wit_id: int, source: str, slot: int) -> None:
        self.inputs.append((wit_id, source, slot))
        self._levels[wit_id] = 0

    def add_instance_input(self, inst_idx: int, source: str, slot: int) -> None:
        """Public-input bit fed from an external tensor (e.g. a CBC IV)."""
        self.inputs.append((inst_idx, source, slot))
        self._levels[inst_idx] = 0

    def add_op(self, wit_id: int, x: int, y: int, s: int,
               coeffs: Tuple[int, ...]) -> None:
        lvl = 1 + max(self._levels.get(x, 0), self._levels.get(y, 0),
                      self._levels.get(s, 0))
        self.records.append(_Record(wit_id, x, y, s, coeffs, lvl))
        self._levels[wit_id] = lvl

    def add_instance_output(self, inst_idx: int, c: int, var: Optional[int],
                            q: int) -> None:
        self.instance_outputs.append((inst_idx, c, var, q))

    @property
    def num_levels(self) -> int:
        return max((r.level for r in self.records), default=0)

    # -- compile -----------------------------------------------------------

    def compile(self, r1cs) -> "CompiledPlan":
        """Freeze into numpy index arrays against final z indices."""
        def fix(v: int) -> int:
            return v if v >= 0 else r1cs.witness_z_index(v)

        levels: Dict[int, List[_Record]] = {}
        for r in self.records:
            levels.setdefault(r.level, []).append(r)

        compiled_levels = []
        for lvl in sorted(levels):
            recs = levels[lvl]
            # coefficients are small signed ints in practice; keep int32
            def signed(c: int) -> int:
                from ..field import R_MOD

                return c if c < R_MOD // 2 else c - R_MOD

            compiled_levels.append(
                LevelArrays(
                    out=np.array([fix(r.out) for r in recs], np.int32),
                    x=np.array([fix(r.x) for r in recs], np.int32),
                    y=np.array([fix(r.y) for r in recs], np.int32),
                    s=np.array([fix(r.s) for r in recs], np.int32),
                    coeffs=np.array(
                        [[signed(c) for c in r.coeffs] for r in recs], np.int32
                    ).T.copy(),
                )
            )
        input_idx: Dict[str, np.ndarray] = {}
        input_slot: Dict[str, np.ndarray] = {}
        for source in sorted({s for _, s, _ in self.inputs}):
            items = [(fix(w), slot) for w, s, slot in self.inputs if s == source]
            input_idx[source] = np.array([w for w, _ in items], np.int32)
            input_slot[source] = np.array([sl for _, sl in items], np.int32)
        inst = self.instance_outputs
        self.compiled = CompiledPlan(
            num_vars=r1cs.num_variables,
            num_instance=r1cs.num_instance,
            levels=compiled_levels,
            input_idx=input_idx,
            input_slot=input_slot,
            inst_idx=np.array([i for i, _, _, _ in inst], np.int32),
            inst_c=np.array([c for _, c, _, _ in inst], np.int32),
            inst_var=np.array(
                [fix(v) if v is not None else 0 for _, _, v, _ in inst], np.int32
            ),
            inst_q=np.array(
                [q if v is not None else 0 for _, _, v, q in inst], np.int32
            ),
        )
        return self.compiled


@dataclass
class LevelArrays:
    out: np.ndarray
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    coeffs: np.ndarray  # [7, m] int32


@dataclass
class CompiledPlan:
    """Frozen evaluation plan (numpy); consumed by numpy or JAX evaluators."""

    num_vars: int
    num_instance: int
    levels: List[LevelArrays]
    input_idx: Dict[str, np.ndarray]
    input_slot: Dict[str, np.ndarray]
    inst_idx: np.ndarray
    inst_c: np.ndarray
    inst_var: np.ndarray
    inst_q: np.ndarray

    # -- host evaluator (oracle; JAX version in ops/witness_jax.py) --------

    def evaluate(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """Compute the full z vector (int32 bits) from input bit tensors.

        inputs: source name -> flat 0/1 bit array (e.g. "message", "key").
        Returns z of length num_vars with z[0] = 1.
        """
        z = np.zeros(self.num_vars, np.int32)
        z[0] = 1
        for source, idx in self.input_idx.items():
            bits = np.asarray(inputs[source], np.int32)
            z[idx] = bits[self.input_slot[source]]
        for lvl in self.levels:
            x = z[lvl.x]
            y = z[lvl.y]
            s = z[lvl.s]
            c = lvl.coeffs
            out = (
                c[0]
                + c[1] * x
                + c[2] * y
                + c[3] * s
                + c[4] * x * y
                + c[5] * s * x
                + c[6] * s * y
            )
            z[lvl.out] = out
        # instance (ciphertext) bits from computed output LCs
        z[self.inst_idx] = self.inst_c + self.inst_q * z[self.inst_var]
        return z
