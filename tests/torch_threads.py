"""Shared helpers of the port's CPU tests (import them into a test module):
one torch thread a test process, the JAX package's native SRS, and the
Plonk chain circuit."""

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
