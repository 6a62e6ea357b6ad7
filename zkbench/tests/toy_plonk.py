"""A toy Plonk cell for the CPU tests: the harness's whole run over a Plonk
circuit small enough to prove on the host in a test.

The toy circuit proves knowledge of a message and key whose bitwise XOR
is the public input: for each bit, m and k are boolean (m m = m, k k = k)
and one gate holds m + k - 2 m k - c = 0 with c the public bit. The
program side builds it with the port's `PlonkCircuit`, takes the port's
SRS from the seed (`kzg.setup`), preprocesses it with the port's
`plonk.setup` and proves with the port's host `plonk.prove`; it writes
the bytes with `plonk_proof_bytes`, the "ZKAESPLK" v1 layout. With
zk=False it proves from an rng whose every draw is 0: both Plonk provers
draw each blinding scalar with `rng.randrange(R_MOD)`, so that is the
proof without blinding. The reference side builds the circuit with its
frozen `PlonkCircuit` copy and derives its own key.
"""

from __future__ import annotations

import copy
import random
import struct

from zkbench import manifest
from zkbench.ref.aes import bits_lsb_first
from zkbench.ref.plonk.circuit import PlonkCircuit as RefPlonkCircuit
from zkbench.ref.plonk.key import derive_key
from zkbench.reference import PlonkReference
from zkbench.tests.toy import xor
from zkbench.traffic import load_mix

SRS_SEED = 6
MSG_LEN = 2


def xor_plonk_circuit(circuit_class, msg_len: int = MSG_LEN):
    """(circuit, message bit vars, key bit vars), public c = m XOR k."""
    c = circuit_class()
    bits = 8 * msg_len
    pub = [c.public_input() for _ in range(bits)]
    m = [c.var() for _ in range(bits)]
    k = [c.var() for _ in range(bits)]
    for ci, mi, ki in zip(pub, m, k):
        c.assert_bool(mi)
        c.assert_bool(ki)
        c.gate(1, 1, -1, -2, 0, mi, ki, ci)
    return c, m, k


def assignment(m_vars, k_vars, message: bytes, key: bytes) -> dict:
    out = dict(zip(m_vars, bits_lsb_first(message)))
    out.update(zip(k_vars, bits_lsb_first(key[:len(message)])))
    return out


class ZeroDraws(random.Random):
    """An rng whose every `randrange` is 0: a Plonk proof without
    blinding."""

    def randrange(self, *args, **kwargs):
        return 0


class ZeroDrawsAt(random.Random):
    """An rng whose `randrange` draws given by their order are 0. Both
    Plonk provers draw two scalars for each of a, b and c, then three for
    z (`Z_DRAWS`), then the quotient's two."""

    def __init__(self, seed, zeros):
        super().__init__(seed)
        self.zeros = set(zeros)
        self.drawn = 0

    def randrange(self, *args, **kwargs):
        value = super().randrange(*args, **kwargs)
        self.drawn += 1
        return 0 if self.drawn - 1 in self.zeros else value


Z_DRAWS = range(6, 9)


def plonk_proof_bytes(proof) -> bytes:
    """A port `PlonkProof` in the "ZKAESPLK" v1 layout, written with the
    port's own point and scalar encodings."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils import (
        ark_serialize as ark)

    points = [proof.comm_a, proof.comm_b, proof.comm_c, proof.comm_z,
              *proof.comm_t]
    out = [b"ZKAESPLK", struct.pack("<I", 1)]
    out += [ark.g1_compressed(c.point) for c in points]
    out += [ark.fr_to_bytes(v) for v in (
        proof.eval_a, proof.eval_b, proof.eval_c, proof.eval_s1,
        proof.eval_s2, proof.eval_zw)]
    out += [ark.g1_compressed(proof.w_zeta.point),
            ark.g1_compressed(proof.w_zeta_omega.point)]
    return b"".join(out)


def toy_cell(traffic: str = "single", trace: bool = False):
    config = manifest.Config(name="toy_plonk", msg_len=MSG_LEN, mode="ecb",
                             msm_engine="mxu", zk=True, srs_seed=SRS_SEED,
                             digest="toy", proof_system="plonk")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [e for e in manifest.load_manifest()[kind]
               if not e.get("workloads")
               or any(w.endswith("." + traffic) for w in e["workloads"])]
    return manifest.Cell(
        name=f"toy_plonk.{traffic}", config=config,
        mix=load_mix(manifest.HERE / "traffic" / f"{traffic}.json"),
        chips=1, metrics=metrics)


class ToyPlonkProgram:
    def __init__(self, config):
        from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg
        from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
            PlonkCircuit, backend)

        self.backend = backend
        self.circuit, self.m, self.k = xor_plonk_circuit(PlonkCircuit,
                                                          config.msg_len)
        n = self.circuit.compile().n
        self.pk = backend.setup(self.circuit, srs=kzg.setup(
            n + 8, random.Random(config.srs_seed)))
        self.serialize = plonk_proof_bytes
        self.config = config
        self.zk = config.zk
        self._memo = {}

    def setup(self) -> None:
        pass

    def _prove(self, message: bytes, key: bytes, seed: int, zk=None):
        """One proof; the same inputs give the same proof, so the tests
        keep each one."""
        zk = self.zk if zk is None else zk
        memo = (message, key, seed, zk)
        if memo not in self._memo:
            public = bits_lsb_first(xor(message, key))
            self._memo[memo] = self.backend.prove(
                self.pk, assignment(self.m, self.k, message, key), public,
                self.circuit,
                rng=random.Random(seed) if zk else ZeroDraws())
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
        return "host"

    def pipeline_depth(self, mix) -> int:
        return 1

    def free(self) -> None:
        pass


class ToyPlonkReference(PlonkReference):
    """The reference side of the toy: its frozen circuit copy and its own
    key, kept in memory."""

    def __init__(self, config):
        self.config = config
        self._circuit, self._m, self._k = xor_plonk_circuit(
            RefPlonkCircuit, config.msg_len)
        self._data = self._circuit.compile()
        self._key = derive_key(self._data, config.srs_seed)

    def instance(self, message: bytes, key: bytes):
        return bits_lsb_first(xor(message, key))

    def wire_columns(self, message: bytes, key: bytes):
        return self._circuit.wire_columns(
            assignment(self._m, self._k, message, key),
            self.instance(message, key))
