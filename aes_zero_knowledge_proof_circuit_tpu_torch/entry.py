"""The flagship forward step — counterpart of `__graft_entry__.entry()`.

    forward, (msg_bits, key_bits) = entry()          # on the CUDA card
    ct_bits, residual = forward(msg_bits, key_bits)

`forward` fills the witness z of the 16-byte AES-128 ECB template
(`WitnessEvaluator`, the vectorised fill of `encrypt`), then takes the
R1CS residual max |Az o Bz - Cz| over the template's COO matrices
(`r1cs_residual`): the ciphertext bits z[1:num_instance] and 0 when the
witness satisfies every constraint. The arithmetic is exact integer
arithmetic, as in the JAX version: the matrices' values are small signed
integers and z holds bits, so Az, Bz and Cz are exact in int64 (int32
there) and a residual means the same in both packages.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import api
from .marlin.prover import coo_arrays
from .ops.witness import WitnessEvaluator
from .utils.device import resolve_device

Coo = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def coo_on(r1cs, device) -> Coo:
    """(row, column, signed value) int64 tensors of A, B and C on
    `device`."""
    return [tuple(torch.from_numpy(a).to(device) for a in triple)
            for triple in coo_arrays(r1cs)]


def r1cs_residual(coo: Coo, z: torch.Tensor,
                  num_constraints: int) -> torch.Tensor:
    """max |Az o Bz - Cz| over the constraints, as a 0-d int64 tensor: each
    matrix-vector product an `index_add_` over its rows (round 1 of
    marlin/prover.py)."""
    z = z.to(torch.int64)
    products = []
    for rows, cols, vals in coo:
        acc = torch.zeros(num_constraints, dtype=torch.int64, device=z.device)
        acc.index_add_(0, rows, vals * z[cols])
        products.append(acc)
    az, bz, cz = products
    return (az * bz - cz).abs().max()


def entry(device="cuda"):
    """(forward, (msg_bits, key_bits)): forward(msg_bits, key_bits) takes
    [128] int32 bit tensors (LSB-first bits of each byte) and returns
    (ct_bits, residual); the example arguments are zero bits on `device`.
    The witness evaluator and the three COO triples are built once, on
    `device` (the CUDA card unless the caller asks for another)."""
    dev = resolve_device(device)
    tpl = api._template_cached(16)
    evaluator = WitnessEvaluator(tpl.plan, dev)
    coo = coo_on(tpl.r1cs, dev)
    num_instance = tpl.r1cs.num_instance
    num_constraints = tpl.r1cs.num_constraints

    def forward(msg_bits, key_bits):
        z = evaluator.evaluate_batch({
            "message": torch.as_tensor(msg_bits)[None],
            "key": torch.as_tensor(key_bits)[None]})[0]
        return z[1:num_instance], r1cs_residual(coo, z, num_constraints)

    zeros = torch.zeros(128, dtype=torch.int32, device=dev)
    return forward, (zeros, zeros.clone())
