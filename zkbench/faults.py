"""A program with one fault planted where its answers are produced.

`Faulty(program, kind)` drives `program` as the harness does and breaks
what it gives back, so that a check can be shown to catch the fault:

- `wrong_statement` (the control): each message is proved with one of
  its bits flipped, so every proof is for another ciphertext than the
  one its message has; this breaks the configurations' `sound`
  guarantee;
- `altered`: the first proof of every call has one evaluation changed
  after the program made it (Marlin's first at beta1, Plonk's eval_a);
- `stale`: every call after the first returns the first call's proofs
  again, a state that never moves on;
- `half`: a call proves the first half of its messages and returns those
  proofs again for the rest;
- `no_zk`: the program proves with zk=False, without the masking that
  the configurations' `zero_knowledge` guarantee states.

The exchange between cards has no fault here: every cell runs on one.
"""

from __future__ import annotations

import copy
import dataclasses

from .ref.field import R_MOD
from .traffic import Call, Mix

KINDS = ("wrong_statement", "altered", "stale", "half", "no_zk")


class Faulty:
    def __init__(self, program, kind: str):
        if kind not in KINDS:
            raise ValueError(f"fault must be one of {KINDS}")
        self.program = program
        self.kind = kind
        self._first = None

    def __getattr__(self, name):
        return getattr(self.program, name)

    def call(self, mix: Mix, call: Call):
        if self.kind == "wrong_statement":
            flipped = [bytes([m[0] ^ 1]) + m[1:] for m in call.messages]
            return self.program.call(
                mix, dataclasses.replace(call, messages=flipped))
        if self.kind == "half":
            half = max(1, len(call.messages) // 2)
            proofs = self.program.call(
                mix, dataclasses.replace(call, messages=call.messages[:half]))
            return [proofs[i % half] for i in range(len(call.messages))]
        if self.kind == "no_zk":
            return self.program.call(mix, call, zk=False)
        proofs = self.program.call(mix, call)
        if self.kind == "stale":
            if self._first is None:
                self._first = proofs
            return self._first
        bad = copy.deepcopy(proofs[0])
        if self.program.config.proof_system == "marlin":
            bad.evals_beta1[0] = (bad.evals_beta1[0] + 1) % R_MOD
        else:
            bad.eval_a = (bad.eval_a + 1) % R_MOD
        return [bad] + list(proofs[1:])

