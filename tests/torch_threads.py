"""Shared helpers of the port's CPU tests (import them into a test module):
one torch thread a test process (and a test's subprocess), the JAX
package's native SRS, the Plonk chain circuit and the Plonk stand-in for
the AES-128 circuit."""

import fcntl
import os
import random
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the plain kernel versions run
    many small tensor ops, and parallel test workers that each spin up a
    full thread pool oversubscribe the cores and stall one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_thread_env(**extra) -> dict:
    """The environment of a test's subprocess that runs torch work: one
    intra-op thread, as `one_torch_thread` gives the test process itself.
    A subprocess does not inherit that pin, and torch starts a thread for
    every core: under six test workers its plain kernels' small ops then
    spin against the workers' and run ten times slower."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                **extra)


def jax_srs(max_degree: int, seed: int):
    """The JAX package's native SRS of `max_degree` from random.Random(seed).

    The JAX package's loader builds its library into one shared temporary
    name without a lock and tries once a process, so a test process that
    loses a build race to another would keep no library. Here the load runs
    under the lock the port's loader takes (`<cache>/native/.build.lock`),
    and a load that failed is tried once more with the loader's one-shot
    flag cleared. A library that still cannot be had fails the test with
    the loader's reason."""
    from aes_zero_knowledge_proof_circuit_tpu import native as jax_native
    from aes_zero_knowledge_proof_circuit_tpu.parallel.srs_gen import (
        generate_srs_native,
    )
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils.native import (
        _Reasons,
    )

    reasons = _Reasons()
    jax_native.log.addHandler(reasons)
    try:
        with open(Path(jax_native._build_dir()) / ".build.lock", "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                if (jax_native.lib() is None
                        and not os.environ.get("ZKAES_NO_NATIVE")):
                    jax_native._TRIED = False
                    jax_native.lib()
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)
    finally:
        jax_native.log.removeHandler(reasons)
    if jax_native.lib() is None:
        why = "; ".join(reasons.messages) or "ZKAES_NO_NATIVE is set"
        pytest.fail(f"the JAX package's native library is unavailable: {why}")
    return generate_srs_native(max_degree, random.Random(seed))


def chain_circuit(circuit_cls, num_gates: int, r_mod: int):
    """The chain circuit of scripts/run_plonk_device.py on `circuit_cls`
    (either package's PlonkCircuit): public out; private x; x_{i+1} = x_i^2
    + x_i with copy constraints throughout; out = the last. (circuit,
    assignment, out); about num_gates gates, so n = 2 num_gates."""
    c = circuit_cls()
    out_pub = c.public_input()
    x = c.var()
    assign = {x: 3}
    cur, val = x, 3
    while len(c.gates) < num_gates - 2:
        sq = c.mul(cur, cur)
        assign[sq] = val * val % r_mod
        s = c.add(sq, cur)
        assign[s] = (val * val + val) % r_mod
        cur, val = s, (val * val + val) % r_mod
    c.assert_equal(cur, out_pub)
    return c, assign, val


class ZeroDraws(random.Random):
    """Every blinding scalar 0: a Plonk host prover's proof without zk."""

    def randrange(self, *args, **kwargs):
        return 0


class NoDraws(random.Random):
    """An rng a zk=False proof must not draw from."""

    def randrange(self, *args, **kwargs):
        raise AssertionError("a zk=False proof drew from its rng")


class CiphertextPairs:
    """A stand-in for `plonk.aes_map.AesPlonkCircuit` with its interface
    (`circuit`, `assign`, `assign_dense`, `public_values`): the same 128
    public values, the AES-128 ciphertext's bits, and one private gate
    for each pair of them (s_i = c_2i + c_2i+1), so n = 256 and a proof on
    the CPU takes seconds. `assign` computes the ciphertext on the host,
    and `assign_dense` is `assign`. It is built on
    `circuit_class` (the port's `PlonkCircuit` by default, or the
    benchmark reference's copy)."""

    def __init__(self, circuit_class=None):
        if circuit_class is None:
            from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
                PlonkCircuit as circuit_class)

        c = circuit_class()
        self.public = [c.public_input() for _ in range(128)]
        self.sums = []
        for i in range(64):
            s = c.var()
            c.gate(1, 1, -1, 0, 0, self.public[2 * i],
                   self.public[2 * i + 1], s)
            self.sums.append(s)
        self.circuit = c

    def assign(self, message: bytes, key: bytes) -> dict:
        from aes_zero_knowledge_proof_circuit_tpu_torch.ops.aes_host import (
            encrypt_ecb)

        bits = self.public_values(bytes(encrypt_ecb(message, key)))
        return {s: bits[2 * i] + bits[2 * i + 1]
                for i, s in enumerate(self.sums)}

    assign_dense = assign

    @staticmethod
    def public_values(ciphertext: bytes):
        from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.aes_map import (
            AesPlonkCircuit)

        return AesPlonkCircuit.public_values(ciphertext)
