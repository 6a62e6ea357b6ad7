"""Prove and verify AES-128 encryption — counterpart of the JAX package's api.

    synthesize_keys(plaintext_length, device=...) -> (AESProvingKey, vk)
    encrypt(message, secret_key, proving_key) -> MarlinProof
    verify_encryption(verifying_key, proof, ciphertext) -> bool
    compute_ciphertext(message, secret_key) -> bytes

The proving state lives on the CUDA card unless `synthesize_keys` is given
another device; without a card it raises. The host code (circuit, KZG
types, transcript, verifier, serialization) is this package's own copy of
the JAX package's, so proofs and verifying keys have the same bytes in both
packages and a proof from either verifies with the other's verifier.
Templates and indexed keys are cached under names of this package's own
(`tpl_torch_*`, `pk_torch_*`), since their pickles name this package's
classes; SRS checkpoints are plain arrays and shared. ECB only: CBC,
`encrypt_batch` and multi-device meshes raise NotPortedError.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .marlin import indexer as _indexer
from .marlin import verifier as _verifier
from .marlin.indexer import MarlinProvingKey, MarlinVerifyingKey
from .marlin.prover import MarlinProof, TorchProver
from .models.aes_circuit import Template, build_template
from .ops import kzg
from .ops.aes_host import encrypt_ecb
from .ops.field_params import R_MOD
from .ops.witness import WitnessEvaluator
from .utils import srs as _srs
from .utils.config import CONFIG
from .utils.device import resolve_device
from .utils.errors import (
    CapacityError,
    InvalidInputError,
    ProofError,
    SerializationError,
    SynthesisError,
    ZkAesError,
    require,
)
from .utils.rng import generate_rand
from .utils.serialize import deserialize_proof, save_srs, serialize_proof

Fr = R_MOD

__all__ = [
    "synthesize_keys", "encrypt", "encrypt_batch", "verify_encryption",
    "compute_ciphertext", "bits_lsb_first", "generate_rand",
    "deserialize_proof", "serialize_proof", "Fr", "ZkAesError",
    "SynthesisError", "InvalidInputError", "CapacityError",
    "SerializationError", "ProofError", "NotPortedError",
]

log = logging.getLogger(__name__)

TEMPLATE_VERSION = 1
INDEX_VERSION = 2   # 2: keys pickle this package's own vk classes


class NotPortedError(ZkAesError, NotImplementedError):
    """A capability of the JAX package that this package does not have yet."""


@dataclass
class AESProvingKey:
    marlin_pk: MarlinProvingKey
    template: Template
    device: torch.device
    setup_times: dict = field(default_factory=dict)
    _prover: Optional[TorchProver] = None
    _witness: Optional[WitnessEvaluator] = None


def bits_lsb_first(data: bytes) -> List[int]:
    """byte_to_field_array semantics (LSB-first bits of each byte)."""
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def _template_cached(msg_len: int) -> Template:
    path = CONFIG.template_dir / f"tpl_torch_ecb_{msg_len}_v{TEMPLATE_VERSION}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    log.info("building AES-ecb circuit template for %d bytes", msg_len)
    tpl = build_template(msg_len, mode="ecb")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tpl, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return tpl


def _srs_for(need: int, rng) -> kzg.SRS:
    """The degree-`need` SRS: the checkpoint, a truncated larger one, or a
    fresh native generation saved as a checkpoint."""
    path = CONFIG.srs_dir / f"srs_bls377_v2_d{need}.npz"
    if path.exists():
        log.info("loading SRS checkpoint %s", path)
        return _srs.load_srs(str(path))
    larger = []
    for p in CONFIG.srs_dir.glob("srs_bls377_v2_d*.npz"):
        try:
            d = int(p.stem.rsplit("_d", 1)[1])
        except (IndexError, ValueError):
            continue
        if d >= need:
            larger.append((d, p))
    if larger:
        _d, p = min(larger)
        log.info("truncating SRS checkpoint %s to degree %d", p, need)
        return _srs.truncate_srs(_srs.load_srs(str(p)), need)
    log.info("generating SRS of degree %d", need)
    srs = _srs.generate_srs_native(need, rng)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    save_srs(tmp, srs)
    os.replace(tmp, path)
    return srs


def _srs_digest(srs: kzg.SRS) -> str:
    """Short content digest binding a pk checkpoint to its exact SRS."""
    h = hashlib.blake2s(digest_size=8)
    packed = _srs.pack_points(srs.powers_g1)
    n = packed.shape[0]
    for i in (0, 1, n // 2, n - 1):
        h.update(packed[i].tobytes())
    h.update(int(srs.max_degree).to_bytes(8, "little"))
    return h.hexdigest()


def _indexed_pk_cached(msg_len: int, tpl: Template, srs: kzg.SRS, device,
                       use_disk_cache: bool) -> MarlinProvingKey:
    """The port's indexer with a disk checkpoint of everything but the SRS,
    under its own name prefix (pk_torch_)."""
    if not use_disk_cache:
        return _indexer.index(tpl.r1cs, srs, device)
    path = CONFIG.template_dir / (
        f"pk_torch_ecb_{msg_len}_v{TEMPLATE_VERSION}_srs{srs.max_degree}"
        f"_{_srs_digest(srs)}_ix{INDEX_VERSION}.pkl")
    if path.exists():
        log.info("loading indexed proving key %s", path)
        with open(path, "rb") as f:
            state = pickle.load(f)
        pk = MarlinProvingKey(
            srs=srs, vk=state["vk"], r1cs=tpl.r1cs, log_n=state["log_n"],
            log_x=state["log_x"], var_to_slot=state["var_to_slot"],
            matrices=state["matrices"])
        pk.coo_np = state["coo_np"]
        pk.torch_points = _srs.device_powers(srs, device)
        return pk
    pk = _indexer.index(tpl.r1cs, srs, device)
    state = dict(vk=pk.vk, log_n=pk.log_n, log_x=pk.log_x,
                 var_to_slot=pk.var_to_slot, matrices=pk.matrices,
                 coo_np=pk.coo_np)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return pk


def synthesize_keys(plaintext_length: int, rng=None,
                    srs: Optional[kzg.SRS] = None, mode: str = "ecb", *,
                    device="cuda") -> Tuple[AESProvingKey, MarlinVerifyingKey]:
    """Trusted setup and circuit indexing, with the proving state on
    `device` (the CUDA card by default). The SRS is sized from the template,
    generated once by the native tier and checkpointed."""
    require(plaintext_length > 0 and plaintext_length % 16 == 0,
            InvalidInputError,
            f"plaintext_length must be a positive multiple of 16, got "
            f"{plaintext_length}")
    if mode != "ecb":
        raise NotPortedError(f"mode={mode!r}: only ECB is ported")
    device = resolve_device(device)
    rng = rng or generate_rand()
    times = {}
    t0 = time.perf_counter()
    tpl = _template_cached(plaintext_length)
    times["template"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    caller_srs = srs is not None
    if srs is None:
        na, nb, nc = tpl.r1cs.nnz()
        need = _indexer.required_degree(tpl.r1cs.num_constraints,
                                        tpl.r1cs.num_variables,
                                        max(na, nb, nc))
        srs = _srs_for(need, rng)
    times["srs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = _indexed_pk_cached(plaintext_length, tpl, srs, device,
                            use_disk_cache=not caller_srs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["index"] = time.perf_counter() - t0
    return AESProvingKey(marlin_pk=pk, template=tpl, device=device,
                         setup_times=times), pk.vk


def encrypt(message: bytes, secret_key: bytes, proving_key: AESProvingKey,
            rng=None, zk: bool = True, iv: Optional[bytes] = None,
            mesh=None) -> MarlinProof:
    """Prove knowledge of (message, key) for the AES-128 ECB ciphertext."""
    if iv is not None:
        raise NotPortedError("CBC proving is not ported")
    if mesh is not None:
        raise NotPortedError("multi-device proving is not ported")
    rng = rng or generate_rand()
    tpl = proving_key.template
    require(len(message) == tpl.msg_len, InvalidInputError,
            f"message is {len(message)} bytes; the proving key was "
            f"synthesized for {tpl.msg_len}")
    require(len(secret_key) == 16, InvalidInputError,
            "secret_key must be exactly 16 bytes (AES-128)")
    if proving_key._witness is None:
        proving_key._witness = WitnessEvaluator(tpl.plan, proving_key.device)
    if proving_key._prover is None:
        proving_key._prover = TorchProver(proving_key.marlin_pk,
                                          proving_key.device)
    z = proving_key._witness.evaluate({
        "message": np.asarray(bits_lsb_first(message), np.int32),
        "key": np.asarray(bits_lsb_first(secret_key), np.int32)})
    num_instance = tpl.r1cs.num_instance
    instance = [1] + [int(v) for v in z[1:num_instance].tolist()]
    return proving_key._prover.prove(instance, z[num_instance:], rng=rng,
                                     zk=zk)


def encrypt_batch(messages, secret_key, proving_key, rng=None, zk=True,
                  mesh=None):
    raise NotPortedError("encrypt_batch is not ported")


def compute_ciphertext(message: bytes, secret_key: bytes,
                       iv: Optional[bytes] = None) -> bytes:
    """AES-128 ECB on the host (the oracle the proof is checked against)."""
    if iv is not None:
        raise NotPortedError("CBC is not ported")
    return bytes(encrypt_ecb(message, secret_key))


def verify_encryption(verifying_key: MarlinVerifyingKey, proof: MarlinProof,
                      ciphertext: bytes, iv: Optional[bytes] = None) -> bool:
    """Public input [1] + LSB-first ciphertext bits, checked by the shared
    Marlin verifier on the host."""
    if iv is not None:
        raise NotPortedError("CBC is not ported")
    require(len(ciphertext) % 16 == 0 and len(ciphertext) > 0,
            InvalidInputError,
            f"ciphertext must be a positive multiple of 16 bytes, got "
            f"{len(ciphertext)}")
    return _verifier.verify(verifying_key, [1] + bits_lsb_first(ciphertext),
                            proof)
