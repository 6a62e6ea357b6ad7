"""The benchmark's plain reference: AES-128, the Marlin verifying key and
the Marlin verifier, in plain Python.

It imports nothing of the program. `aes.py` is the reference's own
AES-128 (FIPS-197); `circuit/` is a frozen copy of the port's circuit
builder; `index.py` works out the verifying key from that circuit and the
SRS's secret exponent, drawn from the configuration's seed as the program
draws it; `proof.py` reads the proof's bytes; `verify.py` replays the
Fiat-Shamir transcript, checks every AHP identity and both batched KZG
openings.
"""
