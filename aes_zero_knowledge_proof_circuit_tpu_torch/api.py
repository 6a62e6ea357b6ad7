"""Prove and verify AES-128 encryption — counterpart of the JAX package's api.

    synthesize_keys(plaintext_length, mode=..., device=...,
                    proof_system="marlin")
        -> (AESProvingKey, vk)
    synthesize_keys(16, proof_system="plonk", device=...)
        -> (AESPlonkProvingKey, PlonkVerifyingKey)
    encrypt(message, secret_key, proving_key, iv=..., mesh=...)
        -> MarlinProof, or a PlonkProof for a Plonk key
    encrypt_batch(messages, secret_key, proving_key, mesh=...)
        -> [MarlinProof] or [PlonkProof]
    verify_encryption(verifying_key, proof, ciphertext, iv=...) -> bool
    compute_ciphertext(message, secret_key, iv=...) -> bytes

The proving state lives on the CUDA card unless `synthesize_keys` is given
another device; without a card it raises. The host code (circuit, KZG
types, transcript, verifier, serialization) is this package's own copy of
the JAX package's, so proofs and verifying keys have the same bytes in both
packages and a proof from either verifies with the other's verifier.
Templates and indexed keys are cached under names of this package's own
(`tpl_torch_*`, `pk_torch_*`), since their pickles name this package's
classes; SRS checkpoints are plain arrays and shared. Both modes are
ported: ECB, and CBC with a public 16-byte iv. `mesh=` takes a
`parallel.mesh.Mesh` (`make_mesh`) of devices of the key's type: one call
drives every device, the prover's 4n-domain transforms and MSMs sharded
over the mesh (marlin/prover.py), and `encrypt_batch` fills the witnesses
data-parallel over it, then proves each on the key's device, as the JAX
package does; the proofs equal the single-device ones. `encrypt_batch`
keeps two proofs in flight, one CUDA stream each, where the JAX package's
rule (4 or more host cores) and the card's free memory allow it
(`pipeline_depth`).

proof_system="plonk" proves one 16-byte ECB block with Plonk (GWC19) on
the same kernels and the same kind of SRS: the AES-128 Plonk circuit
(`plonk/aes_map.py`), its key preprocessed on the device
(`plonk.prover.preprocess`) and cached on disk (`pk_torch_plonk_*`), and
`TorchPlonkProver`, one proof in flight; its proofs serialize as
"ZKAESPLK" v1.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import queue
import random
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .marlin import indexer as _indexer
from .marlin import verifier as _verifier
from .marlin.indexer import MarlinProvingKey, MarlinVerifyingKey
from .marlin.prover import MarlinProof, TorchProver, proof_bytes
from .models.aes_circuit import Template, build_template
from .ops import kzg
from .ops.aes_host import encrypt_cbc, encrypt_ecb
from .ops.field_params import R_MOD
from .ops.witness import WitnessEvaluator, evaluate_sharded
from .parallel.mesh import Mesh, make_mesh
from .plonk import backend as _plonk
from .plonk.aes_map import AesPlonkCircuit
from .plonk.backend import PlonkProof, PlonkProvingKey, PlonkVerifyingKey
from .plonk.prover import TorchPlonkProver, preprocess
from .utils import spans
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
    "SerializationError", "ProofError", "Mesh", "make_mesh",
    "AESPlonkProvingKey",
]

log = logging.getLogger(__name__)

TEMPLATE_VERSION = 2   # 2: R1CS pickles its running nonzero counts
INDEX_VERSION = 2   # 2: keys pickle this package's own vk classes
PLONK_KEY_VERSION = 1  # names the cached Plonk keys
PROOF_SYSTEMS = ("marlin", "plonk")


@dataclass
class AESProvingKey:
    marlin_pk: MarlinProvingKey
    template: Template
    device: torch.device
    setup_times: dict = field(default_factory=dict)
    _prover: Optional[TorchProver] = None
    _witness: Optional[WitnessEvaluator] = None
    # a mesh's prover, and each device's witness evaluator for mesh batches
    _mesh_provers: Dict[Mesh, TorchProver] = field(default_factory=dict)
    _witness_on: Dict[torch.device, WitnessEvaluator] = field(
        default_factory=dict)
    # encrypt_batch's two CUDA streams, one a proof in flight, made on first
    # use: the allocator keeps the blocks a stream freed for that stream
    _streams: Tuple = ()


@dataclass
class AESPlonkProvingKey:
    """A Plonk key of one AES-128 block: the circuit with its witness
    trace (`assign`, `public_values`), the proving key, and the prover
    built once on `device`."""
    circuit: AesPlonkCircuit
    plonk_pk: PlonkProvingKey
    device: torch.device
    setup_times: dict = field(default_factory=dict)
    _prover: Optional[TorchPlonkProver] = None


def bits_lsb_first(data: bytes) -> List[int]:
    """byte_to_field_array semantics (LSB-first bits of each byte)."""
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def _template_cached(msg_len: int, mode: str = "ecb") -> Template:
    path = CONFIG.template_dir / (
        f"tpl_torch_{mode}_{msg_len}_v{TEMPLATE_VERSION}.pkl")
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    log.info("building AES-%s circuit template for %d bytes", mode, msg_len)
    tpl = build_template(msg_len, mode=mode)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tpl, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return tpl


def _srs_degree(tpl: Template) -> int:
    """The SRS degree a template's key needs."""
    na, nb, nc = tpl.r1cs.nnz()
    return _indexer.required_degree(tpl.r1cs.num_constraints,
                                    tpl.r1cs.num_variables, max(na, nb, nc))


def _srs_for(need: int, rng, device="cuda") -> kzg.SRS:
    """The degree-`need` SRS: the checkpoint, a truncated larger one, or a
    fresh generation saved as a checkpoint (on the card, K6, when `device`
    is CUDA; else the native ladder on the host: the same SRS from the same
    rng)."""
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
    log.info("generating SRS of degree %d on %s", need, device)
    if torch.device(device).type == "cuda":
        srs = _srs.generate_srs_device(need, rng, device)
    else:
        srs = _srs.generate_srs_native(need, rng)
    _checkpoint_srs(srs)
    return srs


def _checkpoint_srs(srs: kzg.SRS) -> None:
    """Save `srs` as the checkpoint of its degree (written aside, then
    renamed into place)."""
    path = CONFIG.srs_dir / f"srs_bls377_v2_d{srs.max_degree}.npz"
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    save_srs(tmp, srs)
    os.replace(tmp, path)


def _srs_digest(srs: kzg.SRS) -> str:
    """Short content digest binding a pk checkpoint to its exact SRS."""
    h = hashlib.blake2s(digest_size=8)
    packed = _srs.pack_points(srs.powers_g1)
    n = packed.shape[0]
    for i in (0, 1, n // 2, n - 1):
        h.update(packed[i].tobytes())
    h.update(int(srs.max_degree).to_bytes(8, "little"))
    return h.hexdigest()


def _pk_path(msg_len: int, mode: str, srs: kzg.SRS):
    """Where the indexed key of one template and SRS is checkpointed."""
    return CONFIG.template_dir / (
        f"pk_torch_{mode}_{msg_len}_v{TEMPLATE_VERSION}_srs{srs.max_degree}"
        f"_{_srs_digest(srs)}_ix{INDEX_VERSION}.pkl")


def _indexed_pk_cached(msg_len: int, mode: str, tpl: Template, srs: kzg.SRS,
                       device, use_disk_cache: bool) -> MarlinProvingKey:
    """The port's indexer with a disk checkpoint of everything but the SRS,
    under its own name prefix (pk_torch_)."""
    if not use_disk_cache:
        return _indexer.index(tpl.r1cs, srs, device)
    path = _pk_path(msg_len, mode, srs)
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


def _plonk_pk_path(srs: kzg.SRS):
    """Where the preprocessed key of the AES-Plonk circuit over one SRS is
    cached."""
    return CONFIG.template_dir / (
        f"pk_torch_plonk_ecb_16_v{PLONK_KEY_VERSION}_srs{srs.max_degree}"
        f"_{_srs_digest(srs)}.pkl")


def _plonk_pk_cached(circuit, srs: kzg.SRS, device, use_disk_cache: bool):
    """(PlonkProvingKey, TorchPlonkProver) of the AES-Plonk circuit:
    preprocessed on the device and its eight column commitments cached
    on disk; a cached key is read back and only its columns uploaded."""
    data = circuit.compile()
    path = _plonk_pk_path(srs) if use_disk_cache else None
    if path is not None and path.exists():
        log.info("loading Plonk proving key %s", path)
        with open(path, "rb") as f:
            state = pickle.load(f)
        require(state["n"] == data.n, SynthesisError,
                f"{path} is the key of another circuit")
        return preprocess(data, srs, device, comms=state["comms"])
    pk, prover = preprocess(data, srs, device)
    if path is not None:
        state = dict(n=data.n,
                     comms=pk.vk.comm_selectors + pk.vk.comm_s_sigma)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    return pk, prover


def _synthesize_plonk(plaintext_length: int, rng, srs: Optional[kzg.SRS],
                      mode: str, device
                      ) -> Tuple[AESPlonkProvingKey, PlonkVerifyingKey]:
    require(plaintext_length == 16 and mode == "ecb", InvalidInputError,
            f"AES-Plonk proves one 16-byte ECB block, not {plaintext_length}"
            f" bytes in {mode!r} mode")
    device = resolve_device(device)
    rng = rng or generate_rand()
    times = {}
    t0 = time.perf_counter()
    aes = AesPlonkCircuit()
    n = aes.circuit.compile().n
    times["template"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    caller_srs = srs is not None
    if srs is None:
        srs = _srs_for(n + 5, rng, device)
    times["srs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk, prover = _plonk_pk_cached(aes.circuit, srs, device,
                                  use_disk_cache=not caller_srs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["index"] = time.perf_counter() - t0
    return AESPlonkProvingKey(circuit=aes, plonk_pk=pk, device=device,
                              setup_times=times, _prover=prover), pk.vk


def synthesize_keys(plaintext_length: int, rng=None, *,
                    srs: Optional[kzg.SRS] = None, mode: str = "ecb",
                    device="cuda", proof_system: str = "marlin"):
    """Trusted setup and circuit indexing, with the proving state on
    `device` (the CUDA card by default). The SRS is sized from the template,
    generated once (on the card for a CUDA device, by the native tier on
    the host otherwise) and checkpointed. mode="cbc" chains the blocks on a
    public 16-byte iv. proof_system="plonk" gives (AESPlonkProvingKey,
    PlonkVerifyingKey) for one 16-byte ECB block: its SRS of degree n + 5
    drawn from `rng` as Marlin's is, its key preprocessed on `device`.

    Everything after `rng` is keyword-only: the JAX package's third
    positional parameter is its backend, so a call written for it fails
    here at the call."""
    require(proof_system in PROOF_SYSTEMS, InvalidInputError,
            f"proof_system must be one of {PROOF_SYSTEMS}, got "
            f"{proof_system!r}")
    if proof_system == "plonk":
        return _synthesize_plonk(plaintext_length, rng, srs, mode, device)
    require(plaintext_length > 0 and plaintext_length % 16 == 0,
            InvalidInputError,
            f"plaintext_length must be a positive multiple of 16, got "
            f"{plaintext_length}")
    require(mode in ("ecb", "cbc"), InvalidInputError,
            f"mode must be 'ecb' or 'cbc', got {mode!r}")
    device = resolve_device(device)
    rng = rng or generate_rand()
    times = {}
    t0 = time.perf_counter()
    tpl = _template_cached(plaintext_length, mode)
    times["template"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    caller_srs = srs is not None
    if srs is None:
        srs = _srs_for(_srs_degree(tpl), rng, device)
    times["srs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = _indexed_pk_cached(plaintext_length, mode, tpl, srs, device,
                            use_disk_cache=not caller_srs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["index"] = time.perf_counter() - t0
    return AESProvingKey(marlin_pk=pk, template=tpl, device=device,
                         setup_times=times), pk.vk


def _check_inputs(tpl: Template, messages: Sequence[bytes],
                  secret_key: bytes, iv: Optional[bytes]) -> None:
    """The JAX package's checks of what a proof is asked for, in its order."""
    for m in messages:
        require(len(m) == tpl.msg_len, InvalidInputError,
                f"message is {len(m)} bytes; the proving key was "
                f"synthesized for {tpl.msg_len}")
    require(len(secret_key) == 16, InvalidInputError,
            "secret_key must be exactly 16 bytes (AES-128)")
    if tpl.mode == "cbc":
        require(iv is not None and len(iv) == 16, InvalidInputError,
                "CBC proving keys require a 16-byte iv")
    else:
        require(iv is None, InvalidInputError,
                "iv given but the proving key is for ECB mode")


def _witness_bits(tpl: Template, messages: Sequence[bytes], key: bytes,
                  iv: Optional[bytes] = None) -> Dict[str, np.ndarray]:
    """The witness fill's inputs for a batch of messages under one key:
    source name -> [B, bits] LSB-first bits; CBC templates add the iv."""
    def rows(datas) -> np.ndarray:
        return np.asarray([bits_lsb_first(d) for d in datas], np.int32)

    inputs = {"message": rows(messages), "key": rows([key] * len(messages))}
    if tpl.mode == "cbc":
        inputs["iv"] = rows([iv] * len(messages))
    return inputs


def _check_mesh(mesh, proving_key: AESProvingKey) -> None:
    """`mesh` is None, or a port Mesh of devices of the key's type."""
    require(mesh is None or isinstance(mesh, Mesh), InvalidInputError,
            f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
            f"{type(mesh).__name__}")
    if mesh is not None:
        require(mesh.first.type == proving_key.device.type,
                InvalidInputError,
                f"a mesh of {mesh.first.type} devices for a proving key on "
                f"{proving_key.device}")


def _proving_state(proving_key: AESProvingKey, mesh: Optional[Mesh] = None):
    """The key's witness evaluator and its prover, or the mesh's prover,
    made on first use and kept on the key."""
    if proving_key._witness is None:
        proving_key._witness = WitnessEvaluator(proving_key.template.plan,
                                                proving_key.device)
    if mesh is not None:
        if mesh not in proving_key._mesh_provers:
            proving_key._mesh_provers[mesh] = TorchProver(
                proving_key.marlin_pk, mesh=mesh)
        return proving_key._witness, proving_key._mesh_provers[mesh]
    if proving_key._prover is None:
        proving_key._prover = TorchProver(proving_key.marlin_pk,
                                          proving_key.device)
    return proving_key._witness, proving_key._prover


def _evaluator_on(proving_key: AESProvingKey, device) -> WitnessEvaluator:
    """The key's witness evaluator on `device`, made on first use."""
    if device == proving_key.device:
        return proving_key._witness
    if device not in proving_key._witness_on:
        proving_key._witness_on[device] = WitnessEvaluator(
            proving_key.template.plan, device)
    return proving_key._witness_on[device]


def _prove_z(prover: TorchProver, tpl: Template, z: torch.Tensor, rng,
             zk: bool) -> MarlinProof:
    """Prove one filled witness z: the instance is [1] + z[1:num_instance]
    (the iv bits, for CBC, then the ciphertext bits)."""
    num_instance = tpl.r1cs.num_instance
    with spans.wait("instance_bits", readback=4 * num_instance):
        instance = [1] + z[1:num_instance].tolist()
    return prover.prove(instance, z[num_instance:], rng=rng, zk=zk)


def _check_plonk(messages: Sequence[bytes], secret_key: bytes,
                 iv: Optional[bytes], mesh) -> None:
    """What a Plonk key proves: 16-byte messages under a 16-byte key,
    no iv, on the key's own device."""
    for m in messages:
        require(len(m) == 16, InvalidInputError,
                f"message is {len(m)} bytes; AES-Plonk proves one 16-byte "
                f"block")
    require(len(secret_key) == 16, InvalidInputError,
            "secret_key must be exactly 16 bytes (AES-128)")
    require(iv is None, InvalidInputError,
            "iv given but the proving key is for ECB mode")
    require(mesh is None, InvalidInputError,
            "a Plonk proving key proves on its own device (no mesh)")


def _prove_plonk(proving_key: AESPlonkProvingKey, message: bytes,
                 secret_key: bytes, rng, zk: bool) -> PlonkProof:
    """One Plonk proof on the key's prover: the witness is the circuit's
    trace replayed for (message, key), the public values the ciphertext's
    bits."""
    aes = proving_key.circuit
    public = aes.public_values(compute_ciphertext(message, secret_key))
    return proving_key._prover.prove(
        lambda: aes.assign_dense(message, secret_key), public, aes.circuit,
        rng=rng, zk=zk)


def encrypt(message: bytes, secret_key: bytes, proving_key: AESProvingKey,
            rng=None, zk: bool = True, iv: Optional[bytes] = None,
            mesh=None) -> MarlinProof:
    """Prove knowledge of (message, key) for the AES-128 ciphertext; CBC
    proving keys take the public 16-byte iv. With a `mesh`, the proof runs
    on the mesh's prover (kept on the key, one a mesh) and equals the
    single-device proof from the same rng. A Plonk key gives a PlonkProof;
    with zk=False its eleven blinding scalars are 0."""
    with spans.span("api.encrypt", messages=1):
        if isinstance(proving_key, AESPlonkProvingKey):
            _check_plonk([message], secret_key, iv, mesh)
            return _prove_plonk(proving_key, message, secret_key,
                                rng or generate_rand(), zk)
        _check_mesh(mesh, proving_key)
        rng = rng or generate_rand()
        tpl = proving_key.template
        _check_inputs(tpl, [message], secret_key, iv)
        evaluator, prover = _proving_state(proving_key, mesh)
        z = evaluator.evaluate_batch(_witness_bits(tpl, [message],
                                                   secret_key, iv))[0]
        return _prove_z(prover, tpl, z, rng, zk)


def pipeline_depth(cores: int, proof_bytes: int, free_bytes: int) -> int:
    """How many proofs `encrypt_batch` keeps in flight: two, the JAX
    package's pipeline, on a host of 4 or more cores (its rule) where two
    proofs' working sets, `proof_bytes` each, fit in the `free_bytes` of
    the card; else one. (On an 80 GB card the memory rule keeps a 1 KB
    key to one: two of its proofs do not fit beside the key.)"""
    return 2 if cores >= 4 and 2 * proof_bytes <= free_bytes else 1


def _batch_depth(proving_key: AESProvingKey, prover: TorchProver,
                 batch: int) -> int:
    """pipeline_depth for a batch on the key's device: on a card, from the
    prover's reckoned working set and the card's free memory (what the
    allocator holds unused counted free); a CPU key's proofs live in host
    memory, so only the host's cores count there."""
    if batch < 2:
        return 1
    cores = os.cpu_count() or 1
    dev = proving_key.device
    if dev.type != "cuda":
        return pipeline_depth(cores, 0, 0)
    free, _total = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return pipeline_depth(
        cores, proof_bytes(prover.log_n, prover.d_max, prover.msm_engine),
        free)


def _prove_pipelined(proving_key: AESProvingKey, prover: TorchProver,
                     tpl: Template, zs, seeds, zk: bool) -> List[MarlinProof]:
    """Proof i of zs[i] from random.Random(seeds[i]), two at a time in two
    threads on the one prover, in message order (the JAX package's
    `ThreadPoolExecutor(max_workers=2)`). On a card each proof in flight
    runs on one of the key's two streams, after the calling stream's fill;
    a proof that fails first lets its stream finish, and its error comes
    out here once the other proof has ended."""
    dev = proving_key.device
    if dev.type == "cuda":
        if not proving_key._streams:
            proving_key._streams = (torch.cuda.Stream(dev),
                                    torch.cuda.Stream(dev))
        filled = torch.cuda.Event()
        filled.record(torch.cuda.current_stream(dev))
        free = queue.SimpleQueue()
        for s in proving_key._streams:
            free.put(s)
    root = spans.current()

    def one(i: int) -> MarlinProof:
        if dev.type != "cuda":
            with spans.attach(root):
                return _prove_z(prover, tpl, zs[i], random.Random(seeds[i]),
                                zk)
        s = free.get()
        try:
            with spans.attach(root), torch.cuda.device(dev), \
                    torch.cuda.stream(s):
                s.wait_event(filled)
                zs[i].record_stream(s)
                return _prove_z(prover, tpl, zs[i], random.Random(seeds[i]),
                                zk)
        finally:
            with spans.attach(root), spans.wait("proof_stream"):
                s.synchronize()
            free.put(s)

    with ThreadPoolExecutor(max_workers=2) as ex:
        return list(ex.map(one, range(len(zs))))


def encrypt_batch(messages: List[bytes], secret_key: bytes,
                  proving_key: AESProvingKey, rng=None, zk: bool = True,
                  mesh=None) -> List[MarlinProof]:
    """Prove independent messages under one key with an ECB proving key.
    The witnesses are filled together in one batch (with a `mesh`, padded
    to a multiple of its size and split across its devices, each filling
    its chunk). The proofs run on the key's own prover and device, mesh or
    not, as in the JAX package: proof i from random.Random(seed i) with
    the seeds drawn from `rng` first, so a seeded batch gives its proofs,
    each equal to encrypt()'s from its seed. Two proofs are in flight at
    once, each in a thread of its own and on a CUDA stream of its own,
    where `pipeline_depth` allows it (4 or more host cores, the JAX
    package's rule, and room on the card for a second proof); else they
    follow one after another. Proofs come back in message order; an error
    in either proof is raised here. A Plonk key proves the messages in
    turn, one in flight, each from its seed as above."""
    with spans.span("api.encrypt_batch", messages=len(messages)):
        return _encrypt_batch(messages, secret_key, proving_key, rng, zk,
                              mesh)


def _encrypt_batch(messages, secret_key, proving_key, rng, zk, mesh):
    if isinstance(proving_key, AESPlonkProvingKey):
        require(len(messages) > 0, InvalidInputError, "empty message batch")
        _check_plonk(messages, secret_key, None, mesh)
        rng = rng or generate_rand()
        seeds = [rng.randrange(1 << 62) for _ in messages]
        return [_prove_plonk(proving_key, m, secret_key, random.Random(seed),
                             zk) for m, seed in zip(messages, seeds)]
    _check_mesh(mesh, proving_key)
    require(len(messages) > 0, InvalidInputError, "empty message batch")
    tpl = proving_key.template
    require(tpl.mode == "ecb", InvalidInputError,
            "encrypt_batch supports ECB proving keys (CBC chains blocks)")
    _check_inputs(tpl, messages, secret_key, None)
    rng = rng or generate_rand()
    evaluator, prover = _proving_state(proving_key)
    inputs = _witness_bits(tpl, messages, secret_key)
    if mesh is None:
        zs = evaluator.evaluate_batch(inputs)
    else:
        zs = evaluate_sharded(
            mesh, lambda d: _evaluator_on(proving_key, d), inputs)
    seeds = [rng.randrange(1 << 62) for _ in messages]
    zs = [z.to(proving_key.device) for z in zs]
    if _batch_depth(proving_key, prover, len(zs)) == 1:
        return [_prove_z(prover, tpl, z, random.Random(seed), zk)
                for z, seed in zip(zs, seeds)]
    return _prove_pipelined(proving_key, prover, tpl, zs, seeds, zk)


def compute_ciphertext(message: bytes, secret_key: bytes,
                       iv: Optional[bytes] = None) -> bytes:
    """AES-128 ECB, or CBC when an iv is given, on the host (the oracle the
    proof is checked against)."""
    if iv is not None:
        return bytes(encrypt_cbc(message, secret_key, iv))
    return bytes(encrypt_ecb(message, secret_key))


def verify_encryption(verifying_key: MarlinVerifyingKey, proof: MarlinProof,
                      ciphertext: bytes, iv: Optional[bytes] = None) -> bool:
    """Public input [1] + LSB-first ciphertext bits, with the iv's bits
    before them for CBC, checked by the shared Marlin verifier on the
    host. A Plonk verifying key takes the 16-byte ciphertext's bits alone
    as public values (`plonk.backend.verify`, on the host)."""
    require(len(ciphertext) % 16 == 0 and len(ciphertext) > 0,
            InvalidInputError,
            f"ciphertext must be a positive multiple of 16 bytes, got "
            f"{len(ciphertext)}")
    if isinstance(verifying_key, PlonkVerifyingKey):
        require(iv is None and len(ciphertext) == 16, InvalidInputError,
                "a Plonk verifying key takes one 16-byte ECB ciphertext")
        return _plonk.verify(verifying_key, proof,
                             bits_lsb_first(ciphertext))
    instance = [1]
    if iv is not None:
        require(len(iv) == 16, InvalidInputError, "iv must be 16 bytes")
        instance += bits_lsb_first(iv)
    return _verifier.verify(verifying_key,
                            instance + bits_lsb_first(ciphertext), proof)
