"""Plonk backend (reference README.md:5 roadmap item; BASELINE config #5).

Vanilla Plonk (GWC19) over BLS12-377 sharing the stack's KZG commitment
layer — the same universal powers-of-tau SRS the Marlin prover uses
(SURVEY.md §7 step 10 commitment-layer reuse).
"""

from .backend import (
    PlonkProof,
    PlonkProvingKey,
    PlonkVerifyingKey,
    prove,
    setup,
    verify,
)
from .circuit import PlonkCircuit

__all__ = [
    "PlonkCircuit",
    "PlonkProof",
    "PlonkProvingKey",
    "PlonkVerifyingKey",
    "prove",
    "setup",
    "verify",
]
