"""The port's two-deep proof pipeline (`api.encrypt_batch`, the JAX
package's `ThreadPoolExecutor(max_workers=2)`), on the CPU.

* With the host's cores set to 4 and to 2, `encrypt_batch` hands a
  thread-safe recording prover what the JAX package's hands its own, in
  the same order; with 4 cores exactly two proves are in flight at once,
  with 2 one.
* Two threads proving on one `TorchProver` of the toy circuit give the
  proofs the same seeds give in turn, zk=False and seeded zk=True.
* `pipeline_depth` picks two for the 16- and 64-byte keys and one for the
  1 KB key on an 80 GB card; an error in either proof comes out of
  `encrypt_batch`; launch counts stay exact while threads launch.
"""

import os
import random
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu import api as jax_api
from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer
from aes_zero_knowledge_proof_circuit_tpu_torch import api, convert, kernels
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import prover as tp
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import serialize as ser
from tests.torch_threads import one_torch_thread  # noqa: F401

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
GIB = 1 << 30
# torch.cuda.mem_get_info's total on an H100 80GB HBM3
CARD_BYTES = int(79.18 * GIB)


@pytest.fixture(scope="module")
def ecb16(tmp_path_factory):
    """The 16-byte ECB template of each package (the port's built and
    cached in a directory of this module's own)."""
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    try:
        port = api._template_cached(16, "ecb")
    finally:
        api.CONFIG.cache_dir = old
    from aes_zero_knowledge_proof_circuit_tpu.models.aes_circuit import (
        build_template,
    )

    return port, build_template(16, mode="ecb")


def messages_of(count: int, seed: int):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(count)]


class Recorder:
    """Stands in for a prover: returns what it was handed, and counts the
    proves in flight (the most at once in `most`); with a barrier, each
    prove waits there for another to be in flight beside it."""

    def __init__(self, barrier=None):
        self.barrier = barrier
        self.lock = threading.Lock()
        self.now = 0
        self.most = 0
        self.order = []

    def prove(self, instance, witness, rng=None, zk=True):
        with self.lock:
            self.now += 1
            self.most = max(self.most, self.now)
            self.order.append(rng.getstate())
        try:
            if self.barrier is not None:
                self.barrier.wait()
            return (list(instance), np.asarray(witness).tolist(),
                    rng.getstate(), zk)
        finally:
            with self.lock:
                self.now -= 1


def keys(ecb16, port_prover, ref_prover):
    tpl, ref = ecb16
    port_pk = api.AESProvingKey(marlin_pk=None, template=tpl,
                                device=torch.device("cpu"),
                                _prover=port_prover)
    ref_pk = jax_api.AESProvingKey(marlin_pk=None, template=ref,
                                   backend="jax", _jax_prover=ref_prover)
    return port_pk, ref_pk


@pytest.mark.parametrize("cores", [4, 2])
def test_batch_hands_the_prover_what_the_reference_does(ecb16, monkeypatch,
                                                        cores):
    """Both packages pipeline on 4 cores (each recorder's proves meet at a
    barrier of two) and prove in turn on 2: each hands its prover the same
    instances, witnesses and per-proof Random states, and returns the
    proofs in message order."""
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    messages = messages_of(4, 12)

    def recorder():
        return Recorder(threading.Barrier(2, timeout=30) if cores >= 4
                        else None)

    port, ref = recorder(), recorder()
    port_pk, ref_pk = keys(ecb16, port, ref)
    got = api.encrypt_batch(messages, KEY, port_pk, rng=random.Random(13),
                            zk=False)
    want = jax_api.encrypt_batch(messages, KEY, ref_pk,
                                 rng=random.Random(13), zk=False)
    assert got == want
    assert port.most == ref.most == (2 if cores >= 4 else 1)
    draw = random.Random(13)
    for i, m in enumerate(messages):
        seed = draw.randrange(1 << 62)
        assert got[i][2] == random.Random(seed).getstate()
        ct = api.compute_ciphertext(m, KEY)
        assert got[i][0] == [1] + api.bits_lsb_first(ct)
    if cores < 4:
        assert port.order == [p[2] for p in got]


@pytest.mark.parametrize("cores,depth", [(4, 2), (8, 2), (2, 1)])
def test_proves_in_flight(ecb16, monkeypatch, cores, depth):
    """With 4 or more cores two proves run at once, and never more (each
    waits at a barrier of two, which a lone prove would break by its
    timeout); with 2 cores one at a time."""
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    barrier = threading.Barrier(2, timeout=30) if depth == 2 else None
    rec = Recorder(barrier)
    port_pk, _ref_pk = keys(ecb16, rec, None)
    proofs = api.encrypt_batch(messages_of(4, 14), KEY, port_pk,
                               rng=random.Random(15), zk=False)
    assert len(proofs) == 4 and rec.most == depth and rec.now == 0
    assert api._batch_depth(port_pk, rec, 4) == depth
    assert api._batch_depth(port_pk, rec, 1) == 1


class Failing(Recorder):
    """A recorder whose prove of the message with instance `bad` raises."""

    def __init__(self, bad):
        super().__init__()
        self.bad = bad

    def prove(self, instance, witness, rng=None, zk=True):
        out = super().prove(instance, witness, rng=rng, zk=zk)
        if out[0] == self.bad:
            raise RuntimeError("prove failed")
        return out


@pytest.mark.parametrize("which", [0, 2])
def test_an_error_in_either_proof_comes_out(ecb16, monkeypatch, which):
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    messages = messages_of(3, 16)
    ct = api.compute_ciphertext(messages[which], KEY)
    rec = Failing([1] + api.bits_lsb_first(ct))
    port_pk, _ref_pk = keys(ecb16, rec, None)
    with pytest.raises(RuntimeError, match="prove failed"):
        api.encrypt_batch(messages, KEY, port_pk, rng=random.Random(17))
    assert rec.now == 0


@pytest.fixture(scope="module")
def toy():
    from tests.test_marlin import build_toy_circuit

    cs, assignment = build_toy_circuit()
    na, nb, nc = cs.nnz()
    srs = indexer.generate_universal_srs(
        cs.num_constraints, cs.num_variables, max(na, nb, nc),
        random.Random(21))
    pk = indexer.index(cs, srs)
    return assignment, tp.TorchProver(convert.proving_key_from(pk), "cpu")


@pytest.mark.parametrize("zk", [False, True])
def test_two_threads_on_one_prover_equal_proofs_in_turn(toy, zk):
    """Two threads start their proves together (a barrier) on one prover;
    each proof equals, byte for byte, the proof of the same witness from
    the same seed made afterwards in turn."""
    assignment, prover = toy
    jobs = [assignment(3, 4), assignment(6, 2)]
    start = threading.Barrier(2, timeout=60)

    def one(i):
        inst, wit = jobs[i]
        start.wait()
        return prover.prove(inst, np.asarray(wit), rng=random.Random(40 + i),
                            zk=zk)

    with ThreadPoolExecutor(max_workers=2) as ex:
        together = list(ex.map(one, range(2)))
    for i, (inst, wit) in enumerate(jobs):
        alone = prover.prove(inst, np.asarray(wit), rng=random.Random(40 + i),
                             zk=zk)
        assert ser.serialize_proof(together[i]) == ser.serialize_proof(alone)
    assert ser.serialize_proof(together[0]) != \
        ser.serialize_proof(together[1])


# (message bytes, log n, SRS degree, device bytes resident before the
# batch: the key, its prover and its cached tables on an H100, chip_smoke.py
# and PERF.md section 5)
KEYS = {16: (18, 1 << 20, 2 * GIB), 64: (20, 1 << 22, 3 * GIB),
        1024: (24, 1 << 26, 26 * GIB)}


@pytest.mark.parametrize("msg_len,engine,depth", [
    (16, "mxu", 2), (16, "pallas", 2), (64, "mxu", 2), (64, "pallas", 2),
    (1024, "mxu", 1), (1024, "pallas", 1)])
def test_memory_rule_on_an_80gb_card(msg_len, engine, depth):
    """Two 16- or 64-byte proofs fit beside their key on an 80 GB card;
    two 1 KB proofs do not, even on an empty card. Below 4 cores there is
    one proof in flight, whatever the memory."""
    log_n, degree, resident = KEYS[msg_len]
    need = tp.proof_bytes(log_n, degree, engine)
    assert api.pipeline_depth(8, need, CARD_BYTES - resident) == depth
    assert api.pipeline_depth(2, need, CARD_BYTES - resident) == 1
    if msg_len == 1024:
        assert api.pipeline_depth(8, need, CARD_BYTES) == 1


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """More launching threads than cores, switching as often as the
    interpreter allows: every launch counted once."""
    lib = types.SimpleNamespace(cdll=types.SimpleNamespace(
        zk_field_mul=lambda *args: 0, zk_batch_inv=lambda *args: 0))
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *args: types.SimpleNamespace(cuda_stream=0))
    threads, calls = 2 * (os.cpu_count() or 1), 2000
    kernels.reset_counts()

    def launch():
        for _ in range(calls):
            kernels.field_mul()
            kernels.batch_inv()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for f in [ex.submit(launch) for _ in range(threads)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["fr_ops"] == threads * calls * 4
    kernels.reset_counts()
    assert kernels.launch_counts()["fr_ops"] == 0
