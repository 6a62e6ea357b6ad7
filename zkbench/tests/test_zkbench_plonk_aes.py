"""The frozen AES-Plonk circuit equals the port's: built from both on the
CPU, the same gates, domain, public inputs, coset shifts, selector and
permutation columns, and the same wire columns for a seeded message and
key."""

import random

import pytest

from zkbench.ref.aes import encrypt_ecb


@pytest.fixture(scope="module")
def both():
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
        aes_map as port)
    from zkbench.ref.plonk import aes_map as ref

    return port.AesPlonkCircuit(), ref.AesPlonkCircuit()


def test_the_circuits_are_equal(both):
    port, ref = both
    assert len(port.circuit.gates) == len(ref.circuit.gates) == 272_544
    pd, rd = port.circuit.compile(), ref.circuit.compile()
    assert pd.n == rd.n == 1 << 19 and pd.log_n == rd.log_n == 19
    assert pd.num_public == rd.num_public == 128
    assert tuple(pd.ks) == tuple(rd.ks) and pd.omega == rd.omega
    assert pd.selector_evals == rd.selector_evals
    assert pd.s_sigma_evals == rd.s_sigma_evals


def test_the_wire_columns_are_equal(both):
    port, ref = both
    rng = random.Random(2**33 + 1)
    message, key = rng.randbytes(16), rng.randbytes(16)
    public = ref.public_values(encrypt_ecb(message, key))
    assert public == port.public_values(encrypt_ecb(message, key))
    assert port.circuit.wire_columns(port.assign(message, key), public) == \
        ref.circuit.wire_columns(ref.assign(message, key), public)
