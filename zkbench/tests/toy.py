"""A toy cell for the CPU tests: the harness's whole run, on the port's
CPU path, over a circuit small enough to prove in a test.

The toy circuit proves knowledge of a message and key whose bitwise XOR
is the public input: each bit pair is boolean (m m = m, k k = k) and
(2 m) k = m + k - c. The program side builds it with the port's R1CS,
its SRS with the port's host setup, its key with the port's indexer and
its proofs with `TorchProver` on the CPU; the reference side builds it
with the reference's copy of the R1CS and derives its own key.
"""

from __future__ import annotations

import copy
import random

from zkbench import manifest
from zkbench.ref.aes import bits_lsb_first
from zkbench.ref.field import R_MOD
from zkbench.ref.index import derive_key
from zkbench.reference import AesReference
from zkbench.traffic import load_mix

SRS_SEED = 5
MSG_LEN = 2


def xor_circuit(r1cs_class, msg_len: int = MSG_LEN):
    cs = r1cs_class()
    bits = 8 * msg_len
    c = [cs.new_instance_var() for _ in range(bits)]
    m = [cs.new_witness_var() for _ in range(bits)]
    k = [cs.new_witness_var() for _ in range(bits)]
    for ci, mi, ki in zip(c, m, k):
        cs.enforce({mi: 1}, {mi: 1}, {mi: 1})
        cs.enforce({ki: 1}, {ki: 1}, {ki: 1})
        cs.enforce({mi: 2}, {ki: 1}, {mi: 1, ki: 1, ci: R_MOD - 1})
    return cs.finalized()


def xor(message: bytes, key: bytes) -> bytes:
    return bytes(a ^ b for a, b in zip(message, key))


def toy_cell(traffic: str = "single", trace: bool = False):
    config = manifest.Config(name="toy", msg_len=MSG_LEN, mode="ecb",
                             msm_engine="mxu", zk=True, srs_seed=SRS_SEED,
                             digest="toy")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [e for e in manifest.load_manifest()[kind]
               if not e.get("workloads")
               or any(w.endswith("." + traffic) for w in e["workloads"])]
    return manifest.Cell(
        name=f"toy.{traffic}", config=config,
        mix=load_mix(manifest.HERE / "traffic" / f"{traffic}.json"),
        chips=1, metrics=metrics)


class ToyProgram:
    def __init__(self, config):
        from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
        from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
            TorchProver)
        from aes_zero_knowledge_proof_circuit_tpu_torch.models.r1cs import R1CS
        from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg
        from aes_zero_knowledge_proof_circuit_tpu_torch.utils import (
            serialize)

        cs = xor_circuit(R1CS, config.msg_len)
        na, nb, nc = cs.nnz()
        srs = kzg.setup(indexer.required_degree(
            cs.num_constraints, cs.num_variables, max(na, nb, nc)),
            random.Random(config.srs_seed))
        self.prover = TorchProver(indexer.index(cs, srs, "cpu"), "cpu")
        self.serialize = serialize.serialize_proof
        self.config = config
        self.zk = config.zk
        self._memo = {}

    def setup(self) -> None:
        pass

    def _prove(self, message: bytes, key: bytes, seed: int, zk=None):
        """One proof; the same inputs give the same proof, so the tests
        keep each one (a toy proof takes seconds on the CPU path)."""
        zk = self.zk if zk is None else zk
        memo = (message, key, seed, zk)
        if memo not in self._memo:
            m = bits_lsb_first(message)
            k = bits_lsb_first(key[:len(message)])
            instance = [1] + [a ^ b for a, b in zip(m, k)]
            self._memo[memo] = self.prover.prove(
                instance, m + k, rng=random.Random(seed), zk=zk)
        return copy.deepcopy(self._memo[memo])

    def call(self, mix, call, zk=None):
        rng = random.Random(call.rng_seed)
        if mix.call == "encrypt":
            return [self._prove(call.messages[0], call.key, call.rng_seed,
                                zk)]
        seeds = [rng.randrange(1 << 62) for _ in call.messages]
        return [self._prove(m, call.key, s, zk)
                for m, s in zip(call.messages, seeds)]

    def setup_times(self) -> dict:
        return {}

    def msm_engine(self) -> str:
        return self.prover.msm_engine

    def pipeline_depth(self, mix) -> int:
        return 1

    def free(self) -> None:
        pass


class ToyReference(AesReference):
    """The reference side of the toy: its R1CS copy and its own key, kept
    in memory."""

    def __init__(self, config):
        from zkbench.ref.circuit.r1cs import R1CS

        self._key = derive_key(xor_circuit(R1CS, config.msg_len),
                               config.srs_seed)

    def key(self):
        return self._key

    def instance(self, message: bytes, key: bytes):
        return [1] + bits_lsb_first(xor(message, key))
