"""Experimental ark-serialize-layout proof container (flag-gated).

Reference analog: the crate re-exports ark-serialized Marlin proofs via
`simpleworks::marlin::serialization::deserialize_proof`
(the reference crate's src/lib.rs:52), whose payload is
`ark_marlin::Proof<Fr, MarlinKZG10<Bls12_377>>` written with
`CanonicalSerialize` (arkworks 0.3 derive rules).

This module writes this stack's `MarlinProof` in that *container layout* —
the generic arkworks-0.3 derive byte rules over the generic Proof shape:

    Proof {
        commitments:     Vec<Vec<marlin_pc::Commitment>>,
        evaluations:     Vec<Fr>,
        prover_messages: Vec<ProverMsg<Fr>>,   // written as Option<Vec<Fr>>
        pc_proof: BatchLCProof {
            proof: Vec<kzg10::Proof { w: G1Affine, random_v: Option<Fr> }>,
            evals: Option<Vec<Fr>>,
        },
    }

with the 0.3 primitive encodings this repo already KAT-matches
(utils/ark_serialize.py): Vec = u64 LE length prefix + elements, Option =
u8 tag (0/1) + payload, Fr = 32 bytes LE, G1Affine = 48-byte compressed
x + SWFlags.

HONEST INTEROP CEILING (README "Interop status"): the *layout* follows the
arkworks derive rules, but the *contents* are this stack's own AHP shape —
per-matrix inner sumchecks (round 3 carries three (g2, h2) pairs where
ark-marlin's combined sumcheck carries one) and a blake2s transcript that is
not byte-compatible with the reference's fork of ark-marlin. A reference
verifier will parse this container but MUST NOT be expected to accept the
proof. The flag exists so a future environment with cargo access can diff
layouts byte-by-byte and close the remaining protocol gap.

Enable via `ZKAES_PROOF_CONTAINER=ark` (utils/serialize.py dispatches) or
call `proof_to_ark_bytes` / `proof_from_ark_bytes` directly.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, List, Optional

from ..ops import kzg
from ..ops.curve_host import g1_infinity
from . import ark_serialize as ark

# round layout of this stack's AHP (documented above): names only, for
# self-description and deserialization checks.
_ROUND1 = ("w", "za", "zb", "s")
_ROUND2 = ("t", "g1", "h1")


# -- arkworks 0.3 derive primitives ----------------------------------------


def _w_len(b: BinaryIO, n: int) -> None:
    b.write(struct.pack("<Q", n))


def _r_len(b: BinaryIO) -> int:
    return struct.unpack("<Q", b.read(8))[0]


def _w_opt(b: BinaryIO, present: bool) -> None:
    b.write(b"\x01" if present else b"\x00")


def _r_opt(b: BinaryIO) -> bool:
    tag = b.read(1)
    if tag not in (b"\x00", b"\x01"):
        raise ValueError(f"bad Option tag {tag!r}")
    return tag == b"\x01"


def _w_pc_commitment(b: BinaryIO, comm: kzg.Commitment,
                     shifted: Optional[kzg.Commitment]) -> None:
    """marlin_pc::Commitment { comm, shifted_comm: Option<..> }."""
    b.write(ark.g1_compressed(comm.point))
    _w_opt(b, shifted is not None)
    if shifted is not None:
        b.write(ark.g1_compressed(shifted.point))


def _r_pc_commitment(b: BinaryIO):
    comm = kzg.Commitment(ark.g1_from_compressed(b.read(48)))
    shifted = None
    if _r_opt(b):
        shifted = kzg.Commitment(ark.g1_from_compressed(b.read(48)))
    return comm, shifted


def _w_fr_vec(b: BinaryIO, vals: List[int]) -> None:
    _w_len(b, len(vals))
    for v in vals:
        b.write(ark.fr_to_bytes(v))


def _r_fr_vec(b: BinaryIO) -> List[int]:
    return [ark.fr_from_bytes(b.read(32)) for _ in range(_r_len(b))]


def _w_kzg_proof(b: BinaryIO, op: kzg.OpeningProof) -> None:
    """kzg10::Proof { w: G1Affine, random_v: Option<Fr> } — hiding commits
    always carry the combined hiding evaluation."""
    b.write(ark.g1_compressed(op.w))
    _w_opt(b, True)
    b.write(ark.fr_to_bytes(op.rand_eval))


def _r_kzg_proof(b: BinaryIO) -> kzg.OpeningProof:
    w = ark.g1_from_compressed(b.read(48))
    rand_eval = ark.fr_from_bytes(b.read(32)) if _r_opt(b) else 0
    return kzg.OpeningProof(w=w, rand_eval=rand_eval)


# -- Proof container --------------------------------------------------------


def proof_to_ark_bytes(proof) -> bytes:
    """Write a MarlinProof in the ark-marlin Proof container layout."""
    b = io.BytesIO()
    # commitments: Vec<Vec<Commitment>>
    n_mat = len(proof.comm_g2)
    _w_len(b, 3)
    _w_len(b, len(_ROUND1))
    for name in _ROUND1:
        _w_pc_commitment(b, getattr(proof, "comm_" + name), None)
    _w_len(b, len(_ROUND2))
    for name in _ROUND2:
        shifted = proof.comm_g1_shift if name == "g1" else None
        _w_pc_commitment(b, getattr(proof, "comm_" + name), shifted)
    _w_len(b, 2 * n_mat)
    for m in range(n_mat):
        _w_pc_commitment(b, proof.comm_g2[m], proof.comm_g2_shift[m])
        _w_pc_commitment(b, proof.comm_h2[m], None)
    # evaluations: Vec<Fr> (beta1 block then flattened beta2 blocks)
    flat_beta2 = [v for block in proof.evals_beta2 for v in block]
    _w_fr_vec(b, list(proof.evals_beta1) + flat_beta2)
    # prover_messages: Vec<ProverMsg> as Option<Vec<Fr>>; rounds 1-2 empty,
    # round 3 carries the per-matrix inner-sumcheck sums.
    _w_len(b, 3)
    _w_opt(b, False)
    _w_opt(b, False)
    _w_opt(b, True)
    _w_fr_vec(b, list(proof.sigmas))
    # pc_proof: BatchLCProof { proof: Vec<kzg10::Proof>, evals: Option<..> }
    _w_len(b, 2)
    _w_kzg_proof(b, proof.open_beta1)
    _w_kzg_proof(b, proof.open_beta2)
    _w_opt(b, False)
    return b.getvalue()


def proof_from_ark_bytes(data: bytes):
    """Parse an ark-layout container back into a MarlinProof."""
    from ..marlin.prover import MarlinProof

    b = io.BytesIO(data)
    n_rounds = _r_len(b)
    if n_rounds != 3:
        raise ValueError(f"expected 3 commitment rounds, got {n_rounds}")
    r1 = [_r_pc_commitment(b) for _ in range(_r_len(b))]
    r2 = [_r_pc_commitment(b) for _ in range(_r_len(b))]
    n3 = _r_len(b)
    if n3 % 2 or len(r1) != len(_ROUND1) or len(r2) != len(_ROUND2):
        raise ValueError("unexpected round commitment counts")
    n_mat = n3 // 2
    r3 = [_r_pc_commitment(b) for _ in range(n3)]
    evals = _r_fr_vec(b)
    if _r_len(b) != 3:
        raise ValueError("expected 3 prover messages")
    for _ in range(2):
        if _r_opt(b):
            raise ValueError("rounds 1-2 must carry empty prover messages")
    if not _r_opt(b):
        raise ValueError("round 3 must carry the sigma message")
    sigmas = _r_fr_vec(b)
    if _r_len(b) != 2:
        raise ValueError("expected 2 batch opening proofs")
    open_beta1 = _r_kzg_proof(b)
    open_beta2 = _r_kzg_proof(b)
    if _r_opt(b):
        raise ValueError("BatchLCProof.evals must be None")
    if b.read(1):
        raise ValueError("trailing bytes")

    n_b1 = len(_ROUND1) + 3  # w, za, zb, s + t, g1, h1
    evals_beta1 = evals[:n_b1]
    rest = evals[n_b1:]
    if n_mat == 0 or len(rest) % n_mat:
        raise ValueError("beta2 evaluation block not divisible per matrix")
    per = len(rest) // n_mat
    evals_beta2 = [rest[m * per:(m + 1) * per] for m in range(n_mat)]
    # structural validation (clean parse errors instead of verifier
    # IndexError/AttributeError on malformed blobs)
    if len(sigmas) != n_mat:
        raise ValueError(
            f"sigma count {len(sigmas)} != matrix count {n_mat}")
    if per != 5:
        raise ValueError(f"expected 5 beta2 evaluations per matrix, {per}")
    if len(evals) != n_b1 + 5 * n_mat:
        raise ValueError("evaluation count mismatch")

    return MarlinProof(
        comm_w=r1[0][0], comm_za=r1[1][0], comm_zb=r1[2][0], comm_s=r1[3][0],
        comm_t=r2[0][0], comm_g1=r2[1][0],
        comm_g1_shift=r2[1][1] if r2[1][1] is not None
        else kzg.Commitment(g1_infinity()),
        comm_h1=r2[2][0],
        comm_g2=[r3[2 * m][0] for m in range(n_mat)],
        # absent shifted commitments degrade to infinity uniformly with
        # the g1 handling above (such proofs fail verification; they must
        # not crash the verifier with a None attribute error)
        comm_g2_shift=[
            r3[2 * m][1] if r3[2 * m][1] is not None
            else kzg.Commitment(g1_infinity())
            for m in range(n_mat)],
        comm_h2=[r3[2 * m + 1][0] for m in range(n_mat)],
        sigmas=sigmas,
        evals_beta1=evals_beta1,
        evals_beta2=evals_beta2,
        open_beta1=open_beta1,
        open_beta2=open_beta2,
    )
