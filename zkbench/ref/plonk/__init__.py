"""The benchmark's plain reference for Plonk (GWC19) proofs of AES-128.

It imports nothing of the program. `circuit.py` and `aes_map.py` are
frozen copies of the port's `plonk/circuit.py` and `plonk/aes_map.py`,
with only their import paths changed (the field from `..field`, the S-box
and round constants from `..aes`, the errors from `..errors`); `key.py`
works out the verifying key from the circuit and the SRS's secret
exponent, drawn from the configuration's seed as the program draws it;
`proof.py` reads the proof's bytes (`ZKAESPLK` v1); `verify.py` replays
the port's verifier and checks the two KZG openings with tau.
"""
