"""What decides `correct`: every proof of the window, held to the reference.

For each message a call of the window sent, the proof the program gave
back for it, as bytes, must

- parse by the format's rules and serialize back to the same bytes;
- verify under the reference's own verifying key, for the public input
  of the reference's own AES-128 ciphertext of that message under that
  key;
- fail to verify once one bit of that ciphertext, drawn from the seed,
  is flipped;
- show the zero-knowledge masking the configurations state, as far as
  the bytes can; a check too slow for every proof is made on `SAMPLE`
  proofs of the run, drawn from the seed.

The reference of the cell's proof system (`reference.py`) says how each
of these is read and checked. Each count below is compared with its
limit, and the run is correct when none passes its limit. The
comparisons are exact (a proof verifies or it does not), so every limit
is 0.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

from .ref.proof import ProofBytesError
from .traffic import Call

# name -> limit; in the order the result line prints them
LIMITS = {
    "missing": 0,          # messages sent that got no proof back
    "bad_bytes": 0,        # proofs whose bytes do not parse, or not back
    "unverified": 0,       # proofs the reference verifier refuses
    "tamper_accepted": 0,  # proofs it accepts for a flipped ciphertext bit
    "not_hiding": 0,       # proofs without the zero-knowledge masking
}

SAMPLE = 1             # proofs a run whose masks are checked in full


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
    counts = dict.fromkeys(LIMITS, 0)
    total = sum(len(rec.call.messages) for rec in records)
    sample = set(random.Random(f"zkbench/sample/{seed}").sample(
        range(total), min(SAMPLE, total)))
    attempted = failed = 0
    for rec in records:
        proofs = rec.proofs or []
        for i, message in enumerate(rec.call.messages):
            fault = _one(reference, rec.call, i, message,
                         proofs[i] if i < len(proofs) else None, seed,
                         attempted in sample)
            attempted += 1
            if fault:
                counts[fault] += 1
                failed += 1
    return Verdict(attempted, failed, counts)


def _one(reference, call: Call, i: int, message: bytes,
         data: Optional[bytes], seed: int, sampled: bool) -> Optional[str]:
    """The first fault of one message's proof, or None."""
    if data is None:
        return "missing"
    try:
        parsed = reference.parse(data)
    except ProofBytesError:
        return "bad_bytes"
    if reference.serialize(parsed) != data:
        return "bad_bytes"
    instance = reference.instance(message, call.key)
    if not reference.verify(instance, parsed):
        return "unverified"
    flip = reference.fixed + random.Random(
        f"zkbench/tamper/{seed}/{call.index}/{i}").randrange(
            len(instance) - reference.fixed)
    tampered = list(instance)
    tampered[flip] ^= 1
    if reference.verify(tampered, parsed):
        return "tamper_accepted"
    if not reference.hiding(parsed, message, call.key, sampled):
        return "not_hiding"
    return None
