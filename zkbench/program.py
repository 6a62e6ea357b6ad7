"""The system under test: the PyTorch and CUDA port, through its API.

`Program` is all the harness knows of the port: it makes the proving key
(`api.synthesize_keys`, from the configuration's SRS seed, cached on
disk), drives the entry of the cell's mix (`api.encrypt` or
`api.encrypt_batch`, with `zk=True`), writes a proof's bytes
(`api.serialize_proof`) and lets the key go. The port is imported here,
after `run.py` has set its environment (cache directory, allocator,
MSM engine).

What the port's API has to give for each proof system:

- Marlin (a configuration with no `proof_system`, or `"marlin"`):
  `synthesize_keys(msg_len, random.Random(srs_seed), mode=, device=)`,
  no other keyword; the key's `setup_times` (seconds by phase) and its
  `_prover` (a `TorchProver`: `msm_engine`, and `api._batch_depth`'s
  pipeline depth); `serialize_proof` writes "ZKAESTPU" v2
  (`ref/proof.py`).
- Plonk (`"proof_system": "plonk"`, one 16-byte ECB block):
  `synthesize_keys(16, random.Random(srs_seed), mode="ecb",
  proof_system="plonk", device=)` returns (key, verifying key), with the
  key cached on disk as the Marlin key is and its SRS drawn from that rng
  as `api._srs_for` draws it (tau, then gamma); the key's `setup_times`;
  `encrypt` and `encrypt_batch` prove with Plonk for such a key, and
  `zk=False` draws no blinding scalar (each is 0); `serialize_proof`
  writes "ZKAESPLK" v1 (`ref/plonk/proof.py`). The configuration's MSM
  engine is K3's ("mxu", which `load_config` requires), and a call keeps
  one proof in flight.
"""

from __future__ import annotations

import gc
import random
from typing import List, Optional

from .manifest import Config
from .traffic import Call, Mix

MSM_ENV = {"mxu": "1", "pallas": "0"}   # ZKAES_MSM_MXU for each engine


class Program:
    def __init__(self, config: Config, device: str = "cuda"):
        from aes_zero_knowledge_proof_circuit_tpu_torch import api

        self.api = api
        self.config = config
        self.device = device
        self.key = None

    def setup(self) -> None:
        if self.key is not None:
            return
        system = self.config.proof_system
        other = {} if system == "marlin" else {"proof_system": system}
        self.key, _vk = self.api.synthesize_keys(
            self.config.msg_len, random.Random(self.config.srs_seed),
            mode=self.config.mode, device=self.device, **other)

    def call(self, mix: Mix, call: Call, zk: Optional[bool] = None
             ) -> List[object]:
        """The proofs of one call; `zk` other than the configuration's only
        where a check plants a fault."""
        zk = self.config.zk if zk is None else zk
        rng = random.Random(call.rng_seed)
        if mix.call == "encrypt":
            return [self.api.encrypt(call.messages[0], call.key, self.key,
                                     rng=rng, zk=zk)]
        return self.api.encrypt_batch(call.messages, call.key, self.key,
                                      rng=rng, zk=zk)

    def setup_times(self) -> dict:
        """Seconds of `synthesize_keys`'s phases (template, srs, index)."""
        return dict(self.key.setup_times)

    def msm_engine(self) -> str:
        """The engine the key commits on: a Plonk key always on K3."""
        if self.config.proof_system != "marlin":
            return self.config.msm_engine
        return self.key._prover.msm_engine

    def pipeline_depth(self, mix: Mix) -> int:
        """How many proofs a call of the mix keeps in flight."""
        if mix.call == "encrypt" or self.config.proof_system != "marlin":
            return 1
        return self.api._batch_depth(self.key, self.key._prover,
                                     mix.messages_per_call)

    def serialize(self, proof) -> bytes:
        return self.api.serialize_proof(proof)

    def free(self) -> None:
        self.key = None
        gc.collect()
