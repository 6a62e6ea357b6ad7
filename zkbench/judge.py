"""What decides `correct`: every proof of the window, held to the reference.

For each message a call of the window sent, the proof the program gave
back for it, as bytes, must

- parse by the format's rules and serialize back to the same bytes;
- verify under the reference's own verifying key, for the public input
  [1] + the bits of the reference's own AES-128 ciphertext of that
  message under that key (the transcript, every AHP identity, both
  batched KZG openings);
- fail to verify once one bit of that ciphertext, drawn from the seed,
  is flipped;
- show the zero-knowledge masking the configurations state, as far as
  the bytes can: the mask polynomial s is committed (not the point at
  infinity) and not zero at beta1, and the opening at beta1 carries a
  hiding value that is not zero. A proof made with zk=False has none of
  the three; a zk proof has each but with odds of about 2^-252.

Each count below is compared with its limit, and the run is correct when
none passes its limit. The comparisons are exact (a proof verifies or it
does not), so every limit is 0.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

from .ref import proof as ref_proof
from .ref.verify import verify
from .traffic import Call

# name -> limit; in the order the result line prints them
LIMITS = {
    "missing": 0,          # messages sent that got no proof back
    "bad_bytes": 0,        # proofs whose bytes do not parse, or not back
    "unverified": 0,       # proofs the reference verifier refuses
    "tamper_accepted": 0,  # proofs it accepts for a flipped ciphertext bit
    "not_hiding": 0,       # proofs without the zero-knowledge masking
}

S_INDEX = 3            # s among the round-1 commitments and beta1's values


@dataclass
class Record:
    """One call of the window: when it ran, and what came back."""
    call: Call
    start: float
    end: float
    proofs: Optional[List[bytes]] = None   # serialized, once the window closed
    error: Optional[str] = None


@dataclass
class Verdict:
    attempted: int
    failed: int
    counts: dict

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and all(
            self.counts[k] <= lim for k, lim in LIMITS.items())

    def checks(self) -> dict:
        return {k: {"value": self.counts[k], "limit": lim}
                for k, lim in LIMITS.items()}

    def lines(self) -> List[str]:
        return [f"check {k}: {self.counts[k]} (limit {lim})"
                for k, lim in LIMITS.items()]


def judge(records: List[Record], reference, seed: int) -> Verdict:
    key = reference.key()
    counts = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for rec in records:
        proofs = rec.proofs or []
        for i, message in enumerate(rec.call.messages):
            attempted += 1
            fault = _one(key, reference, rec.call, i, message,
                         proofs[i] if i < len(proofs) else None, seed)
            if fault:
                counts[fault] += 1
                failed += 1
    return Verdict(attempted, failed, counts)


def _one(key, reference, call: Call, i: int, message: bytes,
         data: Optional[bytes], seed: int) -> Optional[str]:
    """The first fault of one message's proof, or None."""
    if data is None:
        return "missing"
    try:
        parsed = ref_proof.parse(data)
    except ref_proof.ProofBytesError:
        return "bad_bytes"
    if ref_proof.serialize(parsed) != data:
        return "bad_bytes"
    instance = reference.instance(message, call.key)
    if not verify(key, instance, parsed):
        return "unverified"
    flip = 1 + random.Random(f"zkbench/tamper/{seed}/{call.index}/{i}"
                             ).randrange(len(instance) - 1)
    tampered = list(instance)
    tampered[flip] ^= 1
    if verify(key, tampered, parsed):
        return "tamper_accepted"
    if not hiding(parsed):
        return "not_hiding"
    return None


def hiding(proof: ref_proof.Proof) -> bool:
    """Whether a proof shows the masking of a zero-knowledge proof."""
    return (proof.comms[S_INDEX] is not None
            and proof.evals_beta1[S_INDEX] != 0
            and proof.openings[0][1] != 0)
