"""Witness fill on device — counterpart of ops/witness_jax.WitnessEvaluator.

Walks the levels of a models/witness_plan.CompiledPlan: per level, gather
x, y and s from z, evaluate the 7-coefficient multiply-add

    out = c0 + c1 x + c2 y + c3 s + c4 xy + c5 sx + c6 sy

and scatter into z. All values are bits, so the whole fill is int32 tensor
work; the plan's index arrays are uploaded once per evaluator. A batch of
witnesses is one [B, num_vars] tensor, filled level by level together;
`evaluate_sharded` splits a batch over a mesh's devices.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..models.witness_plan import CompiledPlan
from ..parallel.mesh import Mesh, on_device, shard_leading
from ..utils import spans
from ..utils.device import resolve_device


class WitnessEvaluator:
    """One circuit template's witness fill on one device."""

    def __init__(self, plan: CompiledPlan, device="cuda"):
        self.plan = plan
        self.device = resolve_device(device)

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
        return self.evaluate_batch(
            {k: np.asarray(v, np.int32)[None] for k, v in inputs.items()})[0]

    def evaluate_batch(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """inputs: source name -> [B, bits] 0/1 bits (arrays, or tensors
        on any device), one row a witness.
        Returns z [B, num_vars] int32 on the evaluator's device: the plan's
        levels walked once for the whole batch, gathering and scattering
        along the last axis (the JAX package vmaps its evaluator)."""
        rows = {np.shape(v)[0] for v in inputs.values()}
        if len(rows) != 1:
            raise ValueError(f"inputs disagree on the batch size: {rows}")
        batch = rows.pop()
        with spans.span("witness.fill", rows=batch):
            z = torch.zeros((batch, self.plan.num_vars), dtype=torch.int32,
                            device=self.device)
            z[:, 0] = 1
            for name, (idx, slot) in self.inputs.items():
                with spans.wait("witness_bits", upload=4 * int(
                        np.prod(np.shape(inputs[name])))):
                    bits = torch.as_tensor(inputs[name], dtype=torch.int32,
                                           device=self.device)
                z[:, idx] = bits[:, slot]
            for out, xi, yi, si, c in self.levels:
                x, y, s = z[:, xi], z[:, yi], z[:, si]
                z[:, out] = (c[0] + c[1] * x + c[2] * y + c[3] * s
                             + c[4] * x * y + c[5] * s * x + c[6] * s * y)
            inst_idx, inst_c, inst_var, inst_q = self.inst
            z[:, inst_idx] = inst_c + inst_q * z[:, inst_var]
        return z


def evaluate_sharded(mesh: Mesh,
                     evaluator_on: Callable[[torch.device], WitnessEvaluator],
                     inputs: Dict[str, np.ndarray]) -> List[torch.Tensor]:
    """A batch's witnesses filled data-parallel over a mesh, as the JAX
    package shards its vmapped fill: every input padded with zero rows to a
    multiple of the mesh size and cut into contiguous chunks
    (`shard_leading`), device i filling chunk i with evaluator_on(device i).
    Returns the batch's witnesses [num_vars] in order, each on the device
    that filled it; the padding's are dropped."""
    batch = {np.shape(v)[0] for v in inputs.values()}
    if len(batch) != 1:
        raise ValueError(f"inputs disagree on the batch size: {batch}")
    chunks = {k: shard_leading(mesh, torch.as_tensor(np.asarray(v, np.int32)))
              for k, v in inputs.items()}
    out: List[torch.Tensor] = []
    for i, d in enumerate(mesh.devices):
        with on_device(d):
            out += list(evaluator_on(d).evaluate_batch(
                {k: c[i] for k, c in chunks.items()}))
    return out[:batch.pop()]
