"""A sharded step on small shapes over an n-device mesh — counterpart of
`__graft_entry__.dryrun_multichip`.

    python -m aes_zero_knowledge_proof_circuit_tpu_torch.parallel.dryrun 4

Runs, each checked against the host: the four-step sharded NTT (forward,
and the inverse back to the input), the point-sharded MSM on both engines
at 32 and 128 points, the data-parallel witness fill of the 16-byte AES
template over a batch one longer than the mesh (so that it pads), and a
zk proof of a toy circuit on the mesh prover, equal byte for byte to the
single-device proof from the same seed, verified and rejected against a
wrong instance. The mesh is `make_mesh(n_devices, device)`: on CUDA the
visible cards, cuda:(i mod their count), so one card takes every shard.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np

from ..marlin import indexer, verifier
from ..marlin.prover import TorchProver
from ..models.r1cs import R1CS
from ..ops import msm_host, poly_host
from ..ops.aes_host import encrypt_ecb
from ..ops.curve_host import g1_generator
from ..ops.field import fr_ops
from ..ops.field_params import R_MOD
from ..ops.msm import points_from_packed, xyzz_to_affine
from ..ops.witness import WitnessEvaluator, evaluate_sharded
from ..utils.serialize import serialize_proof
from ..utils.srs import generate_srs_native, pack_points
from .mesh import make_mesh, replicated
from .sharded_msm import ENGINES, msm_sharded
from .sharded_ntt import ntt_sharded

F = fr_ops()


def _toy_circuit() -> R1CS:
    """out = x^9 in four constraints, one public output."""
    cs = R1CS()
    out = cs.new_instance_var()
    x, x2, x4, x8 = (cs.new_witness_var() for _ in range(4))
    cs.enforce({x: 1}, {x: 1}, {x2: 1})
    cs.enforce({x2: 1}, {x2: 1}, {x4: 1})
    cs.enforce({x4: 1}, {x4: 1}, {x8: 1})
    cs.enforce({x8: 1}, {x: 1}, {out: 1})
    return cs.finalized()


def dryrun_multichip(n_devices: int, device="cuda", say=print) -> None:
    """The checks above on make_mesh(n_devices, device); raises on any
    mismatch."""
    from .. import api

    mesh = make_mesh(n_devices, device)
    first = mesh.first
    rng = random.Random(0)
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        say(f"dryrun [{time.perf_counter() - t0:6.1f}s] {what}")

    mark(f"mesh of {mesh.size} on {[str(d) for d in mesh.devices]}")
    log_n1 = max(1, (n_devices - 1).bit_length())
    log_n2 = 5 - log_n1 if log_n1 < 5 else 1
    coeffs = [rng.randrange(R_MOD) for _ in range(1 << (log_n1 + log_n2))]
    x = F.from_ints(coeffs, first)
    evals = ntt_sharded(mesh, x, log_n1, log_n2)
    if F.to_ints(evals) != poly_host.domain(log_n1 + log_n2).ntt(coeffs):
        raise AssertionError("sharded NTT mismatch")
    if F.to_ints(ntt_sharded(mesh, evals, log_n1, log_n2, True)) != coeffs:
        raise AssertionError("sharded inverse NTT mismatch")
    mark(f"sharded four-step NTT 2^{log_n1}+{log_n2} verified, both ways")

    g = g1_generator()
    step = g.mul_scalar(rng.randrange(1, R_MOD))
    pts = [g.mul_scalar(rng.randrange(1, R_MOD))]
    while len(pts) < 128:
        pts.append(pts[-1].add(step))
    points = replicated(mesh, points_from_packed(pack_points(pts), first))
    for n in (32, 128):
        scalars = [rng.randrange(R_MOD) for _ in range(n)]
        want = msm_host.msm(pts[:n], scalars)
        limbs = F.from_ints(scalars, first, mont=False)
        for engine in ENGINES:
            got = msm_sharded(mesh, points, limbs, engine)
            if xyzz_to_affine(got)[0] != want:
                raise AssertionError(f"sharded MSM mismatch ({engine}, {n})")
    mark(f"sharded MSM verified at 32 and 128 points on {ENGINES}")

    tpl = api._template_cached(16)
    batch = n_devices + 1
    msgs = [bytes([i] * 16) for i in range(batch)]
    key = bytes(16)
    inputs = {"message": np.asarray([api.bits_lsb_first(m) for m in msgs],
                                    np.int32),
              "key": np.asarray([api.bits_lsb_first(key)] * batch, np.int32)}
    evaluators = {}

    def evaluator_on(d):
        if d not in evaluators:
            evaluators[d] = WitnessEvaluator(tpl.plan, d)
        return evaluators[d]

    zs = evaluate_sharded(mesh, evaluator_on, inputs)
    for m, z in zip(msgs, zs):
        bits = z[1:tpl.r1cs.num_instance].cpu().numpy().reshape(16, 8)
        if bytes((bits << np.arange(8)).sum(1).astype(np.uint8).tolist()) \
                != bytes(encrypt_ecb(m, key)):
            raise AssertionError("data-parallel witness mismatch")
    mark(f"data-parallel witness fill of {batch} blocks verified")

    cs = _toy_circuit()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    pk = indexer.index(cs, generate_srs_native(need, rng), first)
    xv = 3
    inst = [1, pow(xv, 9, R_MOD)]
    wit = [xv, xv ** 2, xv ** 4, xv ** 8]
    proof = TorchProver(pk, mesh=mesh).prove(inst, wit, random.Random(5))
    single = TorchProver(pk, first).prove(inst, wit, random.Random(5))
    if serialize_proof(proof) != serialize_proof(single):
        raise AssertionError("the mesh proof differs from the single-device "
                             "proof")
    if not verifier.verify(pk.vk, inst, proof):
        raise AssertionError("the mesh proof does not verify")
    if verifier.verify(pk.vk, [1, (inst[1] + 1) % R_MOD], proof):
        raise AssertionError("the mesh proof verifies a wrong instance")
    mark("mesh proof of the toy circuit equals the single-device one, "
         "verifies, wrong instance rejected")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
