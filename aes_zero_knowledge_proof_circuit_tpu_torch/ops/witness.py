"""Witness fill on device — counterpart of ops/witness_jax.WitnessEvaluator.

Walks the levels of a models/witness_plan.CompiledPlan: per level, gather
x, y and s from z, evaluate the 7-coefficient multiply-add

    out = c0 + c1 x + c2 y + c3 s + c4 xy + c5 sx + c6 sy

and scatter into z. All values are bits, so the whole fill is int32 tensor
work; the plan's index arrays are uploaded once per evaluator.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu.models.witness_plan import CompiledPlan


class WitnessEvaluator:
    """One circuit template's witness fill on one device."""

    def __init__(self, plan: CompiledPlan, device):
        self.plan = plan
        self.device = torch.device(device)

        def up(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int64)).to(self.device)

        self.levels = [
            (up(lvl.out), up(lvl.x), up(lvl.y), up(lvl.s),
             up(lvl.coeffs).to(torch.int32))
            for lvl in plan.levels
        ]
        self.inputs = {k: (up(plan.input_idx[k]), up(plan.input_slot[k]))
                       for k in plan.input_idx}
        self.inst = (up(plan.inst_idx), up(plan.inst_c).to(torch.int32),
                     up(plan.inst_var), up(plan.inst_q).to(torch.int32))

    def evaluate(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """inputs: source name -> flat 0/1 bits. Returns z [num_vars] int32
        on the evaluator's device, z[0] = 1."""
        z = torch.zeros(self.plan.num_vars, dtype=torch.int32,
                        device=self.device)
        z[0] = 1
        for name, (idx, slot) in self.inputs.items():
            bits = torch.as_tensor(np.asarray(inputs[name], np.int32),
                                   device=self.device)
            z[idx] = bits[slot]
        for out, xi, yi, si, c in self.levels:
            x, y, s = z[xi], z[yi], z[si]
            z[out] = (c[0] + c[1] * x + c[2] * y + c[3] * s + c[4] * x * y
                      + c[5] * s * x + c[6] * s * y)
        inst_idx, inst_c, inst_var, inst_q = self.inst
        z[inst_idx] = inst_c + inst_q * z[inst_var]
        return z
