"""The reference side of a cell: the public input each proof must be for,
the verifying key the reference works out for itself, and how a proof of
the cell's proof system is read and checked (`parse`, `serialize`,
`verify`, `hiding`, and `fixed`, the instance's leading entries that no
tamper flip touches), which is all the judge asks of it.

The key depends on the configuration alone (its proof system, its
circuit and its SRS seed), so the reference derives it once per
checkout, in the first run of the cell, and keeps it in the cell's cache
directory beside the program's caches, under a name of its own
(`ref_key_*.json` for Marlin, `ref_plonk_key_*.json` for Plonk). Nothing
of the program is read: the circuit is the reference's frozen copy, the
SRS exponent is drawn from the seed. `make_reference` picks the
reference of the configuration's proof system.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import List

from .manifest import Config
from .ref import proof as ref_proof
from .ref.aes import bits_lsb_first, encrypt_ecb
from .ref.index import RefKey, derive_key
from .ref.plonk import proof as plonk_proof
from .ref.plonk.key import (PlonkRefKey, derive_key as derive_plonk_key,
                            grand_product)
from .ref.plonk.verify import permutation_challenges, verify as plonk_verify
from .ref.verify import verify

log = logging.getLogger(__name__)

REF_VERSION = 1      # bump when the derivation changes: names the cache
PLONK_REF_VERSION = 1
S_INDEX = 3          # s among Marlin's round-1 commitments and beta1's values


def _write_json(path: Path, d: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(d))
    os.replace(tmp, path)


def hiding(proof: ref_proof.Proof) -> bool:
    """Whether a Marlin proof shows the masking of a zero-knowledge proof:
    the mask polynomial s is committed (not the point at infinity) and
    not zero at beta1, and the opening at beta1 carries a hiding value
    that is not zero."""
    return (proof.comms[S_INDEX] is not None
            and proof.evals_beta1[S_INDEX] != 0
            and proof.openings[0][1] != 0)


class AesReference:
    """Marlin: the key of the frozen R1CS, the instance [1] + the bits;
    proofs in "ZKAESTPU" v2 (`ref/proof.py`), verified by the transcript,
    every AHP identity and both batched KZG openings (`ref/verify.py`)."""

    proof_system = "marlin"
    fixed = 1                      # the instance's leading 1
    parse = staticmethod(ref_proof.parse)
    serialize = staticmethod(ref_proof.serialize)

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
        _write_json(self.path, key.to_json())
        return key

    def ciphertext(self, message: bytes, key: bytes) -> bytes:
        return encrypt_ecb(message, key)

    def instance(self, message: bytes, key: bytes) -> List[int]:
        """[1] + the ciphertext's bits, least significant first."""
        return [1] + bits_lsb_first(self.ciphertext(message, key))

    def verify(self, instance: List[int], proof: ref_proof.Proof) -> bool:
        return verify(self.key(), instance, proof)

    def hiding(self, proof: ref_proof.Proof, message: bytes, key: bytes,
               sampled: bool) -> bool:
        return hiding(proof)


class PlonkReference:
    """Plonk: the key of the frozen AES-Plonk circuit, the public values
    (the ciphertext's 128 bits); proofs in "ZKAESPLK" v1
    (`ref/plonk/proof.py`), verified by the transcript, the
    linearisation and the two KZG openings (`ref/plonk/verify.py`).

    A proof hides its witness when none of comm_a, comm_b and comm_c is
    the commitment to its unblinded wire column and, on a proof of the
    run's sample, comm_z is not the commitment to the unblinded grand
    product; the reference works both out from its own witness of the
    message and key (and z with the proof's beta and gamma). A proof made
    with zk=False fails; a blinded one passes but with odds of about
    2^-252 a commitment. z takes seconds of Python at n = 2^19, so only
    the sample's proofs pay it. The quotient's split blinding is not
    checked: it needs the quotient on the 4n coset."""

    proof_system = "plonk"
    fixed = 0
    parse = staticmethod(plonk_proof.parse)
    serialize = staticmethod(plonk_proof.serialize)

    def __init__(self, config: Config, cache_dir: Path):
        self.config = config
        self.path = Path(cache_dir) / (
            f"ref_plonk_key_{config.name}_{config.digest}"
            f"_v{PLONK_REF_VERSION}.json")
        self._key = None
        self._aes = None
        self._data = None
        self._wires = None          # (message, key, columns) of the last

    def key(self) -> PlonkRefKey:
        if self._key is None:
            self._key = self._load() or self._derive()
        return self._key

    def _load(self):
        if not self.path.exists():
            return None
        return PlonkRefKey.from_json(json.loads(self.path.read_text()),
                                     self.config.srs_seed)

    def _derive(self) -> PlonkRefKey:
        log.info("reference: building the AES-Plonk circuit and its key")
        key = derive_plonk_key(self.compiled(), self.config.srs_seed)
        _write_json(self.path, key.to_json())
        return key

    def circuit(self):
        """The frozen AES-Plonk circuit with its witness trace, built once."""
        if self._aes is None:
            from .ref.plonk.aes_map import AesPlonkCircuit

            self._aes = AesPlonkCircuit()
        return self._aes

    def compiled(self):
        """The circuit's table (selectors, sigma columns), compiled once."""
        if self._data is None:
            self._data = self.circuit().circuit.compile()
        return self._data

    def ciphertext(self, message: bytes, key: bytes) -> bytes:
        return encrypt_ecb(message, key)

    def instance(self, message: bytes, key: bytes) -> List[int]:
        """The ciphertext's bits, least significant first."""
        return bits_lsb_first(self.ciphertext(message, key))

    def wire_columns(self, message: bytes, key: bytes):
        if self._wires is None or self._wires[:2] != (message, key):
            aes = self.circuit()
            self._wires = (message, key, aes.circuit.wire_columns(
                aes.assign(message, key), self.instance(message, key)))
        return self._wires[2]

    def wire_commitments(self, message: bytes, key: bytes):
        """The commitments to the unblinded columns a, b and c."""
        k = self.key()
        return [k.commit_column(col)
                for col in self.wire_columns(message, key)]

    def z_commitment(self, message: bytes, key: bytes,
                     proof: plonk_proof.PlonkProof):
        """The commitment to the unblinded grand product of the proof's
        beta and gamma."""
        k = self.key()
        beta, gamma = permutation_challenges(
            k, self.instance(message, key), proof)
        return k.commit_column(grand_product(
            self.wire_columns(message, key),
            self.compiled().s_sigma_evals, k.omega, k.ks, beta, gamma))

    def verify(self, instance: List[int],
               proof: plonk_proof.PlonkProof) -> bool:
        return plonk_verify(self.key(), instance, proof)

    def hiding(self, proof: plonk_proof.PlonkProof, message: bytes,
               key: bytes, sampled: bool) -> bool:
        plain = self.wire_commitments(message, key)
        if any(c == p for c, p in zip(
                (proof.comm_a, proof.comm_b, proof.comm_c), plain)):
            return False
        return not sampled or proof.comm_z != self.z_commitment(
            message, key, proof)


REFERENCES = {"marlin": AesReference, "plonk": PlonkReference}


def make_reference(config: Config, cache_dir: Path):
    """The reference of the configuration's proof system."""
    return REFERENCES[config.proof_system](config, cache_dir)
