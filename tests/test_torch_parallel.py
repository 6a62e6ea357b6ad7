"""The port's mesh (parallel/) on CPU meshes, held to the JAX package and
the host with zero tolerance: the four-step sharded NTT against the JAX
package's on its 8-device CPU mesh and against the single-device NTT, the
batched plain K2 pass against the per-row transform, the point-sharded MSM
on both engines against the host MSM, the data-parallel witness fill of
`encrypt_batch(mesh=)` against `evaluate_batch` and the AES oracle, the
mesh paths of the API, the kernel wrappers' device guard, and the dryrun.
The mesh proofs of the u32 add circuit are in
tests/test_torch_parallel_prover.py (zk=False) and
tests/test_torch_parallel_zk.py (zk=True)."""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aes_zero_knowledge_proof_circuit_tpu.marlin.prover_jax import JaxProver
from aes_zero_knowledge_proof_circuit_tpu.ops import poly_host
from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
    digits_to_ints,
    fr_f32,
    ints_to_digits,
)
from aes_zero_knowledge_proof_circuit_tpu.parallel import mesh as jax_mesh
from aes_zero_knowledge_proof_circuit_tpu.parallel import (
    sharded_ntt as jax_sharded_ntt,
)
from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_host
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import ntt as N
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.curve_host import (
    g1_generator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.msm import (
    points_from_packed,
    xyzz_to_affine,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.witness import (
    WitnessEvaluator,
    evaluate_sharded,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import (
    Mesh,
    chunk_bounds,
    make_mesh,
    replicated,
    shard_leading,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.sharded_msm import (
    msm_sharded,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.sharded_ntt import (
    four_step_split,
    ntt_sharded,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import pack_points
from tests.torch_threads import one_torch_thread  # noqa: F401

F = fr_ops()
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def rand_ints(seed: int, n: int):
    raw = np.random.default_rng(seed).bytes(n * 40)
    return [int.from_bytes(raw[40 * i: 40 * i + 40], "little") % R_MOD
            for i in range(n)]


# -- the mesh ------------------------------------------------------------------


def test_mesh_shapes_and_placement():
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.first == torch.device("cpu")
    assert mesh.axis == api.CONFIG.mesh_axis == "shard"
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(devices=["cpu", "cpu"]) == Mesh(
        (torch.device("cpu"),) * 2)
    t = torch.arange(10).reshape(5, 2)
    parts = shard_leading(make_mesh(4, "cpu"), t)
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 4
    assert torch.equal(torch.cat(parts)[:5], t)
    assert int(torch.cat(parts)[5:].abs().sum()) == 0
    copies = replicated(make_mesh(3, "cpu"), t)
    assert all(c is t for c in copies)
    assert chunk_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert chunk_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


@pytest.mark.parametrize("devices", [["cuda:5"], ["cpu", "cuda"], []],
                         ids=["invisible-card", "mixed", "empty"])
def test_mesh_of_devices_that_are_not_there_raises(devices):
    """A mesh naming a card that is not visible raises (here there is no
    card at all); it never becomes a CPU mesh."""
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(devices=devices)


@pytest.mark.parametrize("log_n,ndev", [(5, 4), (11, 4), (20, 4), (26, 4),
                                        (7, 8), (3, 8), (22, 1)])
def test_four_step_split_is_jax_provers(log_n, ndev):
    jp = SimpleNamespace(mesh=SimpleNamespace(devices=np.empty(ndev)))
    assert four_step_split(log_n, ndev) == JaxProver._four_step_split(
        jp, log_n)


# -- the sharded NTT -----------------------------------------------------------


@pytest.mark.parametrize("log_n1,log_n2,inverse", [(3, 4, False),
                                                   (3, 3, True)])
def test_sharded_ntt_matches_jax_on_8_devices(log_n1, log_n2, inverse):
    """tests/test_parallel.py's shapes: 3 + 4 forward against the host
    domain, 3 + 3 as a round trip; the port's mesh of 8 CPU shards equals
    the JAX package's program on its 8 CPU devices, and the port's
    single-device transform."""
    n = 1 << (log_n1 + log_n2)
    coeffs = rand_ints(log_n1 + log_n2, n)
    g = fr_f32()
    jmesh = jax_mesh.make_mesh()
    mesh = make_mesh(8, "cpu")
    x = F.from_ints(coeffs, "cpu")
    got = ntt_sharded(mesh, x, log_n1, log_n2)
    want = jax_sharded_ntt.ntt_sharded(jmesh, jnp.asarray(
        ints_to_digits(g, coeffs)), log_n1, log_n2)
    assert F.to_ints(got) == digits_to_ints(g, want)
    assert torch.equal(got, N.ntt_engine(log_n1 + log_n2, "cpu").ntt(x))
    if inverse:
        back = ntt_sharded(mesh, got, log_n1, log_n2, inverse=True)
        jback = jax_sharded_ntt.ntt_sharded(jmesh, want, log_n1, log_n2,
                                            inverse=True)
        assert F.to_ints(back) == coeffs == digits_to_ints(g, jback)
    else:
        assert F.to_ints(got) == poly_host.domain(log_n1 + log_n2).ntt(
            coeffs)


@pytest.mark.parametrize("ndev,log_n1,log_n2", [(4, 2, 3), (3, 2, 2),
                                                (8, 3, 1), (2, 5, 6),
                                                (1, 4, 4)])
def test_sharded_ntt_equals_single_device(ndev, log_n1, log_n2):
    """Even and uneven splits (3 shards; 8 shards over 2 rows of k2, so
    that six take none) both ways, bit for bit."""
    n = 1 << (log_n1 + log_n2)
    x = F.from_ints(rand_ints(n + ndev, n), "cpu")
    mesh = make_mesh(ndev, "cpu")
    eng = N.ntt_engine(log_n1 + log_n2, "cpu")
    assert torch.equal(ntt_sharded(mesh, x, log_n1, log_n2), eng.ntt(x))
    assert torch.equal(ntt_sharded(mesh, x, log_n1, log_n2, inverse=True),
                       eng.intt(x))


def test_sharded_ntt_rejects_wrong_shape_or_device():
    mesh = make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="expected"):
        ntt_sharded(mesh, F.from_ints(range(8), "cpu"), 2, 2)


# -- the batched K2 pass ---------------------------------------------------------


@pytest.mark.parametrize("log_n,pass_log", [(5, 2), (6, 10), (7, 3), (1, 10)])
def test_batched_plain_pass_equals_per_row(log_n, pass_log):
    """NTTEngine.ntt_rows / intt_rows on [B, n, 8] (K2's plain passes over
    the batch) equal the transform of each row."""
    eng = N.NTTEngine(log_n, "cpu", pass_log)
    rows = torch.stack([F.from_ints(rand_ints(10 * log_n + b, 1 << log_n),
                                    "cpu") for b in range(3)])
    fwd = eng.ntt_rows(rows)
    inv = eng.intt_rows(rows)
    for b in range(3):
        assert torch.equal(fwd[b], eng.ntt(rows[b]))
        assert torch.equal(inv[b], eng.intt(rows[b]))
    assert torch.equal(eng.intt_rows(fwd), rows)
    with pytest.raises(ValueError, match=r"\[B, n, 8\]"):
        eng.ntt_rows(rows[0])


def test_plain_pass_batch_with_bitrev_and_scale():
    """One pass (stages 0 .. 2 of 2^5, bit-reversed read, a scale) over a
    batch equals the pass over each row."""
    eng = N.NTTEngine(5, "cpu")
    rows = torch.stack([F.from_ints(rand_ints(b, 32), "cpu")
                        for b in range(4)])
    scale = F.from_ints([7], "cpu")
    got = N.plain_pass(rows, eng.fwd_table, 5, 0, 3, True, scale)
    for b in range(4):
        assert torch.equal(got[b], N.plain_pass(rows[b], eng.fwd_table, 5, 0,
                                                3, True, scale))


# -- the sharded MSM -------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_points():
    """256 related points (a chain P, P + Q, P + 2Q, ...): host scalar
    multiplications cost about 30 ms each."""
    rng = random.Random(4)
    g = g1_generator()
    step = g.mul_scalar(rng.randrange(1, R_MOD))
    pts = [g.mul_scalar(rng.randrange(1, R_MOD))]
    while len(pts) < 256:
        pts.append(pts[-1].add(step))
    return pts


@pytest.mark.parametrize("engine,n", [("mxu", 64), ("mxu", 256),
                                      ("pallas", 64), ("pallas", 250)])
def test_msm_sharded_matches_host(chain_points, engine, n):
    """4 shards, each on its own replica of the points; 250 pads the last
    shard (63 + 63 + 63 + 61)."""
    scalars = rand_ints(n, n)
    scalars[0] = 0                       # zero scalars add nothing
    mesh = make_mesh(4, "cpu")
    points = replicated(mesh, points_from_packed(pack_points(chain_points),
                                                 "cpu"))
    got = msm_sharded(mesh, points, F.from_ints(scalars, "cpu", mont=False),
                      engine)
    assert got.shape == (4, 12) and got.device == mesh.first
    assert xyzz_to_affine(got)[0] == msm_host.msm(chain_points[:n], scalars)


def test_msm_sharded_checks_its_inputs(chain_points):
    mesh = make_mesh(2, "cpu")
    pts = points_from_packed(pack_points(chain_points[:4]), "cpu")
    s = F.from_ints([1, 2, 3, 4], "cpu", mont=False)
    with pytest.raises(ValueError, match="replicas"):
        msm_sharded(mesh, [pts], s)
    with pytest.raises(ValueError, match="engine"):
        msm_sharded(mesh, [pts, pts], s, "fused")
    with pytest.raises(ValueError, match="scalars"):
        msm_sharded(mesh, [pts, pts[:3]], s)


# -- the data-parallel witness fill and the API's mesh paths ----------------------


@pytest.fixture(scope="module")
def ecb16(tmp_path_factory):
    """The port's 16-byte ECB template, built in a cache of this module's
    own, which stays the package's cache while the module's tests run."""
    old = api.CONFIG.cache_dir
    api.CONFIG.cache_dir = str(tmp_path_factory.mktemp("cache"))
    try:
        yield api._template_cached(16, "ecb")
    finally:
        api.CONFIG.cache_dir = old


@pytest.mark.parametrize("batch", [1, 4, 5])
def test_sharded_witness_fill_equals_one_device(ecb16, batch):
    """Batches of 1 and 5 on a mesh of 4 pad; each witness equals the
    single-device fill's and carries the AES oracle's ciphertext bits."""
    tpl = ecb16
    gen = np.random.default_rng(batch)
    messages = [gen.integers(0, 256, 16, dtype=np.uint8).tobytes()
                for _ in range(batch)]
    inputs = api._witness_bits(tpl, messages, KEY)
    one = WitnessEvaluator(tpl.plan, "cpu")
    made = []

    def evaluator_on(d):
        made.append(d)
        return WitnessEvaluator(tpl.plan, d)

    zs = evaluate_sharded(make_mesh(4, "cpu"), evaluator_on, inputs)
    assert len(made) == 4 and len(zs) == batch
    want = one.evaluate_batch(inputs)
    for i, m in enumerate(messages):
        assert torch.equal(zs[i], want[i])
        ct = api.compute_ciphertext(m, KEY)
        assert zs[i][1:tpl.r1cs.num_instance].tolist() == \
            api.bits_lsb_first(ct)


class Recorder:
    """Stands in for a prover: returns what it was handed, and keeps it."""

    def __init__(self):
        self.calls = []

    def prove(self, instance, witness, rng=None, zk=True):
        got = (list(instance), np.asarray(witness).tolist(), rng.getstate(),
               zk)
        self.calls.append(got)
        return got


class MustNotProve:
    """Stands in for a mesh's prover that encrypt_batch must not call."""

    def prove(self, *args, **kwargs):
        raise AssertionError("encrypt_batch(mesh=) proved on the mesh")


def test_encrypt_batch_on_a_mesh_hands_its_prover_the_single_device_inputs(
        ecb16):
    """encrypt_batch(mesh=) of 3 messages on a mesh of 2 (padded to 4):
    the fill runs on the mesh, and the key's own prover gets the instances,
    witnesses and per-proof rngs that the single-device batch hands it; the
    mesh's prover is never called, and a mesh without one gets none made.
    encrypt(mesh=) proves through the mesh's prover."""
    gen = np.random.default_rng(12)
    messages = [gen.integers(0, 256, 16, dtype=np.uint8).tobytes()
                for _ in range(3)]
    mesh = make_mesh(2, "cpu")
    key_prover = Recorder()
    pk = api.AESProvingKey(marlin_pk=None, template=ecb16,
                           device=torch.device("cpu"), _prover=key_prover)
    pk._mesh_provers[mesh] = MustNotProve()
    want = api.encrypt_batch(messages, KEY, pk, rng=random.Random(5))
    # two proves may be in flight (the pipeline): the recorder sees them in
    # either order, the batch returns them in message order
    assert sorted(key_prover.calls) == sorted(want) and len(want) == 3
    got = api.encrypt_batch(messages, KEY, pk, rng=random.Random(5),
                            mesh=mesh)
    assert got == want
    assert sorted(key_prover.calls[3:]) == sorted(want)
    fresh = make_mesh(3, "cpu")
    assert api.encrypt_batch(messages, KEY, pk, rng=random.Random(5),
                             mesh=fresh) == want
    assert list(pk._mesh_provers) == [mesh]     # no mesh prover was made
    pk._mesh_provers[mesh] = Recorder()
    pk._prover = None
    assert api.encrypt(messages[1], KEY, pk, rng=random.Random(9),
                       mesh=mesh) == Recorder().prove(
        want[1][0], want[1][1], random.Random(9), True)
    assert pk._prover is None           # the key's own prover was not made


def test_mesh_of_another_device_type_is_refused(ecb16):
    pk = api.AESProvingKey(marlin_pk=None, template=ecb16,
                           device=torch.device("cuda"))
    with pytest.raises(api.InvalidInputError, match="mesh of cpu"):
        api.encrypt(bytes(16), KEY, pk, mesh=make_mesh(2, "cpu"))


# -- the kernel wrappers' device guard ---------------------------------------------


class OnCard1:
    """Stands in for an int32 tensor on cuda:1 (there is no card here):
    what the wrappers check before they launch."""

    def __init__(self, *shape):
        self.shape = torch.Size(shape)
        self.dtype = torch.int32
        self.device = torch.device("cuda", 1)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def _k1():
    F.mul(OnCard1(4, 8), OnCard1(4, 8))


def _k2():
    N.ntt_pass(OnCard1(8, 8), OnCard1(8, 8), OnCard1(4, 8), 3, 0, 3, True)


def _k3():
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.msm import bucket_msm

    bucket_msm(OnCard1(4, 2, 12), None, None, OnCard1(2 * 5 + 1), 2, 4, 3,
               OnCard1(2, 4, 12))


def _k4():
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.msm_pallas import (
        scan_msm,
    )

    scan_msm(OnCard1(4, 2, 12), None, OnCard1(32, 4, 12))


def _k6():
    from aes_zero_knowledge_proof_circuit_tpu_torch.ops.fixed_base import (
        fixed_base,
    )

    fixed_base(OnCard1(32, 256, 2, 12), OnCard1(4, 8))


@pytest.mark.parametrize("call", [_k1, _k2, _k3, _k4, _k6],
                         ids=["k1", "k2", "k3", "k4", "k6"])
def test_wrapper_refuses_a_tensor_off_the_current_card(monkeypatch, call):
    """A CUDA tensor that is not on torch.cuda.current_device() raises
    ValueError before anything is built or launched (the launch would read
    another card's memory from this card's stream)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match="current CUDA device is cuda:0"):
        call()


def test_check_device_passes_cpu_and_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    kernels.check_device(torch.zeros(2), OnCard1(2))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError):
        kernels.check_device(torch.zeros(2), OnCard1(2))


def test_dryrun_multichip_on_a_cpu_mesh(ecb16):
    """The dryrun on 4 CPU shards: sharded NTT and MSMs, the data-parallel
    fill of 5 blocks, and a toy-circuit zk proof on the mesh prover equal
    to the single-device one (about 40 s)."""
    from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )

    lines = []
    dryrun_multichip(4, "cpu", say=lines.append)
    assert len(lines) == 5 and "equals the single-device one" in lines[-1]

