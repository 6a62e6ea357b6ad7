"""The AES-128 R1CS circuit, frozen for the benchmark's reference.

`r1cs.py`, `gadgets.py`, `witness_plan.py` and `aes_circuit.py` are copies
of the port's `models/` modules of the same names, with only their import
paths changed (the field modulus from `..field`, the S-box and round
constants from `..aes`). The reference builds the constraint system itself
from them, so that the verifying key it derives owes nothing to the
program's template. A later change to the port's circuit shows up as
proofs that this reference rejects.
"""
