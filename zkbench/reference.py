"""The reference side of a cell: the public input each proof must be for,
and the verifying key the reference works out for itself.

The key depends on the configuration alone (its circuit and its SRS
seed), so the reference derives it once per checkout, in the first run
of the cell, and keeps it in the cell's cache directory beside the
program's caches, under a name of its own (`ref_key_*.json`). Nothing of
the program is read: the circuit is the reference's frozen copy, the SRS
exponent is drawn from the seed.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import List

from .manifest import Config
from .ref.aes import bits_lsb_first, encrypt_ecb
from .ref.index import RefKey, derive_key

log = logging.getLogger(__name__)

REF_VERSION = 1      # bump when the derivation changes: names the cache


class AesReference:
    def __init__(self, config: Config, cache_dir: Path):
        self.config = config
        self.path = Path(cache_dir) / (
            f"ref_key_{config.name}_{config.digest}_v{REF_VERSION}.json")
        self._key = None

    def key(self) -> RefKey:
        if self._key is None:
            self._key = self._load() or self._derive()
        return self._key

    def _load(self):
        if not self.path.exists():
            return None
        return RefKey.from_json(json.loads(self.path.read_text()),
                                self.config.srs_seed)

    def _derive(self) -> RefKey:
        from .ref.circuit.aes_circuit import build_template

        log.info("reference: building the %d-byte circuit and its key",
                 self.config.msg_len)
        r1cs = build_template(self.config.msg_len, mode="ecb").r1cs
        key = derive_key(r1cs, self.config.srs_seed)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(key.to_json()))
        os.replace(tmp, self.path)
        return key

    def ciphertext(self, message: bytes, key: bytes) -> bytes:
        return encrypt_ecb(message, key)

    def instance(self, message: bytes, key: bytes) -> List[int]:
        """[1] + the ciphertext's bits, least significant first."""
        return [1] + bits_lsb_first(self.ciphertext(message, key))
