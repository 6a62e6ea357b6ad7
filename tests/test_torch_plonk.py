"""The port's Plonk slice against the JAX package, on the CPU (plain kernel
versions), with integers and zero tolerance.

* `PlonkCircuit.compile()` and `wire_columns` equal the JAX package's on
  the arithmetic and xor circuits of tests/test_plonk.py, a chain of 2^8
  gates and the whole AES-128 circuit (272,544 gates, n = 2^19);
* `wire_arrays`' int64 path gives the gate-by-gate path's columns and
  names the same first unsatisfied gate; both return arrays (int64, or
  Python ints where a value does not fit);
* `AesPlonkCircuit.assign_dense` equals `assign`, and falls back to it
  where int64 would not be exact;
* the AES circuit rejects a tampered ciphertext, and its S-box and xtime
  gates compute the AES tables;
* `FieldOps.prefix_mul` equals F32Ops._prefix_mul and the host product;
* the port's `setup`, and `preprocess` on the device, give the JAX
  package's verifying key;
* a zk=False proof draws nothing and equals the JAX package's host
  prover's with every blinding scalar 0;
* `TorchPlonkProver` proofs equal `JaxPlonkProver`'s and both host
  provers', field for field, on the arithmetic circuit and on the chain
  (n = 2^9: its 4n coset, 2^11, runs K2's plain version in two passes), and
  verify; the proof also runs with the JAX package blocked."""

import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from aes_zero_knowledge_proof_circuit_tpu.ops.aes_host import encrypt_ecb
from aes_zero_knowledge_proof_circuit_tpu.ops.field_f32 import (
    digits_to_ints,
    fr_f32,
)
from aes_zero_knowledge_proof_circuit_tpu.plonk import PlonkCircuit as JaxCircuit
from aes_zero_knowledge_proof_circuit_tpu.plonk import backend as jax_backend
from aes_zero_knowledge_proof_circuit_tpu.plonk.aes_map import (
    AesPlonkCircuit as JaxAesCircuit,
)
from aes_zero_knowledge_proof_circuit_tpu.plonk.backend_jax import (
    JaxPlonkProver,
)
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.aes_host import SBOX
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
    PlonkCircuit,
    backend,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
    circuit as circuit_mod,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.aes_map import (
    AesPlonkCircuit,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
    TorchPlonkProver,
    field_rows,
    preprocess,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.errors import ZkAesError
from tests.torch_threads import (
    NoDraws,
    ZeroDraws,
    chain_circuit,
    jax_srs,
    one_thread_env,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

F = fr_ops()
ROOT = Path(__file__).resolve().parent.parent
MSG = bytes(range(16))
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CHAIN_GATES = 1 << 8


# -- circuits, built the same way on either package's PlonkCircuit ----------


def arith(cls):
    """tests/test_plonk.py:22: public z; private x, y with x*y + (x + 3) ==
    z. (circuit, assignment, public values) for x = 6, y = 11."""
    c = cls()
    z_pub = c.public_input()
    x, y = c.var(), c.var()
    xy = c.mul(x, y)
    x3 = c.add_const(x, 3)
    s = c.add(xy, x3)
    c.assert_equal(s, z_pub)
    xv, yv = 6, 11
    z = (xv * yv + xv + 3) % R_MOD
    return c, {x: xv, y: yv, xy: xv * yv, x3: xv + 3, s: z}, [z]


def xor_demo(cls):
    """tests/test_plonk.py:87: four public xor bits of private x, y."""
    c = cls()
    pub = [c.public_input() for _ in range(4)]
    xs = [c.var() for _ in range(4)]
    ys = [c.var() for _ in range(4)]
    assign = {}
    xv, yv = 0b1100, 0b1010
    for i, (xb, yb) in enumerate(zip(xs, ys)):
        c.assert_bool(xb)
        c.assert_bool(yb)
        z = c.xor_bits(xb, yb)
        c.assert_equal(z, pub[i])
        bx, by = (xv >> i) & 1, (yv >> i) & 1
        assign.update({xb: bx, yb: by, z - 2: bx & by, z - 1: bx + by,
                       z: bx ^ by})
    return c, assign, [((xv ^ yv) >> i) & 1 for i in range(4)]


def chain(cls):
    c, assign, out = chain_circuit(cls, CHAIN_GATES, R_MOD)
    return c, assign, [out]


def pt(p):
    """An affine point of either package as plain integers."""
    return (True, 0, 0) if p.inf else (False, int(p.x), int(p.y))


def proof_fields(proof):
    """Every commitment (a, b, c, z, the three t parts, both openings) and
    every evaluation of a Plonk proof of either package."""
    comms = [proof.comm_a, proof.comm_b, proof.comm_c, proof.comm_z,
             *proof.comm_t, proof.w_zeta, proof.w_zeta_omega]
    return ([pt(c.point) for c in comms],
            [proof.eval_a, proof.eval_b, proof.eval_c, proof.eval_s1,
             proof.eval_s2, proof.eval_zw])


def assert_same_compile(jc, tc, assign, public):
    jd, td = jc.compile(), tc.compile()
    assert (td.n, td.log_n, td.omega, td.ks, td.num_public) == (
        jd.n, jd.log_n, jd.omega, tuple(jd.ks), jd.num_public)
    assert td.selector_evals == jd.selector_evals
    assert td.s_sigma_evals == jd.s_sigma_evals
    assert td.sigma == jd.sigma
    cols = tc.wire_columns(assign, public)
    assert [list(c) for c in cols] == [
        list(c) for c in jc.wire_columns(assign, public)]
    return td


# -- the circuit ------------------------------------------------------------------


@pytest.fixture(scope="module")
def aes_circuits():
    """The AES-128 circuit of both packages, compiled."""
    pair = JaxAesCircuit(), AesPlonkCircuit()
    for ac in pair:
        ac.circuit.compile()
    return pair


@pytest.mark.parametrize("build", [arith, xor_demo, chain],
                         ids=["arith", "xor", "chain"])
def test_compile_matches_jax(build):
    jc, assign, public = build(JaxCircuit)
    tc, _, _ = build(PlonkCircuit)
    assert_same_compile(jc, tc, assign, public)


@pytest.mark.parametrize("build, dtype", [
    (arith, np.int64), (xor_demo, np.int64), (chain, object)],
    ids=["arith", "xor", "chain"])
def test_wire_arrays_equal_the_gate_by_gate_path(build, dtype, monkeypatch):
    tc, assign, public = build(PlonkCircuit)
    fast = tc.wire_arrays(assign, public)
    assert all(isinstance(c, np.ndarray) and c.dtype == dtype for c in fast)
    assert [c.tolist() for c in fast] == list(tc.wire_columns(assign, public))
    bad = dict(assign)
    bad[min(assign)] += 1
    with pytest.raises(ZkAesError) as fast_error:
        tc.wire_arrays(bad, public)
    # no selector lies within 1 of 0 but 0: every gate is checked in turn
    monkeypatch.setattr(circuit_mod, "SMALL", 1)
    slow_circuit, _, _ = build(PlonkCircuit)
    slow = slow_circuit.wire_arrays(assign, public)
    assert all(isinstance(c, np.ndarray) and c.dtype == dtype for c in slow)
    assert [c.tolist() for c in fast] == [c.tolist() for c in slow]
    with pytest.raises(ZkAesError) as slow_error:
        slow_circuit.wire_arrays(bad, public)
    assert str(fast_error.value) == str(slow_error.value)
    assert "unsatisfied" in str(fast_error.value)


def test_aes_compile_matches_jax(aes_circuits):
    jac, tac = aes_circuits
    ct = bytes(encrypt_ecb(MSG, KEY))
    assign = tac.assign(MSG, KEY)
    assert assign == jac.assign(MSG, KEY)
    public = tac.public_values(ct)
    assert public == jac.public_values(ct)
    td = assert_same_compile(jac.circuit, tac.circuit, assign, public)
    assert len(tac.circuit.gates) == 272_544
    assert (td.n, td.num_public) == (1 << 19, 128)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_aes_assign_dense_equals_the_replay(aes_circuits, seed):
    _jac, tac = aes_circuits
    rng = random.Random(seed)
    message, key = rng.randbytes(16), rng.randbytes(16)
    public = tac.public_values(bytes(encrypt_ecb(message, key)))
    assign = tac.assign(message, key)
    dense = tac.assign_dense(message, key)
    assert isinstance(dense, np.ndarray) and dense.dtype == np.int64
    assert dense.shape == (tac.circuit.num_vars,)
    want = np.zeros(tac.circuit.num_vars, np.int64)
    want[list(assign)] = list(assign.values())
    assert (dense == want).all()
    assert [c.tolist() for c in tac.circuit.wire_arrays(dense, public)] == \
        [c.tolist() for c in tac.circuit.wire_arrays(assign, public)]
    flipped = list(public)
    flipped[seed] ^= 1
    with pytest.raises(ZkAesError):
        tac.circuit.wire_arrays(dense, flipped)


@pytest.mark.parametrize("qc", [-5, R_MOD - 5, 1 << 20],
                         ids=["negative", "reduced", "large"])
def test_assign_dense_falls_back_to_the_replay(qc):
    """A value or a coefficient outside int64's exact range gives
    `assign`'s dict."""
    ac = AesPlonkCircuit(build=False)
    x, y = ac._input(0, 0), ac._input(1, 0)
    ac._add2(ac._bilin(x, y, 1, 0, 0, qc), x)
    message, key = b"\x01" + bytes(15), bytes(16)
    dense = ac.assign_dense(message, key)
    assert isinstance(dense, dict)
    assert dense == ac.assign(message, key)


def test_aes_tampered_ciphertext_raises(aes_circuits):
    _jac, tac = aes_circuits
    ct = bytearray(encrypt_ecb(MSG, KEY))
    ct[5] ^= 0x40
    with pytest.raises(ZkAesError):
        tac.circuit.wire_columns(tac.assign(MSG, KEY),
                                 tac.public_values(bytes(ct)))


def _eval_trace(ac, inputs):
    """tests/test_plonk_aes.py's replay of the value trace."""
    vals = {0: 0}
    for var, op in ac.trace:
        k = op[0]
        if k == 0:
            vals[var] = inputs[(op[1], op[2])]
        elif k == 1:
            _, x, y, qm, ql, qr, qc = op
            vals[var] = (qm * vals[x] * vals[y] + ql * vals[x]
                         + qr * vals[y] + qc) % (2**255)
        else:
            _, x, y, cx, cy = op
            vals[var] = cx * vals[x] + cy * vals[y]
    return vals


@pytest.mark.parametrize("piece", ["sbox", "xtime"])
def test_aes_piece_gates(piece):
    """tests/test_plonk_aes.py:36,46 on the port's circuit."""
    ac = AesPlonkCircuit(build=False)
    bits = [ac._input(0, i) for i in range(8)]
    out = ac._sbox(bits) if piece == "sbox" else ac._xtime(bits)
    for byte in (0x00, 0x01, 0x53, 0x80, 0xC3, 0x57, 0xFF, 0x3A):
        vals = _eval_trace(ac, {(0, i): (byte >> i) & 1 for i in range(8)})
        got = sum(vals[out[j]] << j for j in range(8))
        if piece == "sbox":
            assert got == int(SBOX[byte])
        else:
            assert got == ((byte << 1) ^ (0x1B if byte & 0x80 else 0)) & 0xFF


# -- field rows and the prefix product ------------------------------------------


def test_field_rows_small_path_equals_from_ints():
    cases = [[0, 1, 0, 1, 1], [3, R_MOD - 1, R_MOD - 2, 7, (1 << 61)],
             [5, R_MOD // 2 + 1, 1 << 70, 2], [R_MOD - (1 << 62), 1],
             [R_MOD - (1 << 62) + 1], [(1 << 63) - 1, 0], [1 << 63, 1]]
    for vals in cases:
        assert F.to_ints(field_rows(vals, "cpu")) == [v % R_MOD
                                                      for v in vals]
        assert field_rows(vals, "cpu").equal(F.from_ints(vals, "cpu"))


@pytest.mark.parametrize("n", [1, 5, 1 << 10])
def test_prefix_mul_matches_jax_and_host(n):
    rnd = random.Random(n)
    vals = [rnd.randrange(R_MOD) for _ in range(n)]
    got = F.to_ints(F.prefix_mul(F.from_ints(vals, "cpu")))
    want, acc = [], 1
    for v in vals:
        acc = acc * v % R_MOD
        want.append(acc)
    assert got == want
    fj = fr_f32()
    digits = convert.fr_to_f32_digits(F.from_ints(vals, "cpu"))
    assert digits_to_ints(fj, fj._prefix_mul_j(jnp.asarray(digits))) == want


# -- setup and the prover ----------------------------------------------------------


@pytest.fixture(scope="module", params=[arith, chain], ids=["arith", "chain"])
def keys(request):
    """(JAX circuit, port circuit, assignment, public values, JAX proving
    key, its conversion, the port's setup on the same SRS)."""
    jc, assign, public = request.param(JaxCircuit)
    tc, _, _ = request.param(PlonkCircuit)
    srs = jax_srs(jc.compile().n + 8, 3)
    jpk = jax_backend.setup(jc, srs=srs)
    tpk = backend.setup(tc, srs=convert.srs_from(srs))
    return jc, tc, assign, public, jpk, convert.plonk_proving_key_from(jpk), tpk


def test_setup_matches_jax(keys):
    _jc, _tc, _assign, _public, jpk, _pk, tpk = keys
    assert [pt(c.point) for c in tpk.vk.comm_selectors + tpk.vk.comm_s_sigma] \
        == [pt(c.point) for c in jpk.vk.comm_selectors + jpk.vk.comm_s_sigma]
    assert tpk.selector_polys == jpk.selector_polys
    assert tpk.s_sigma_polys == jpk.s_sigma_polys
    assert pt(tpk.vk.kzg_vk.g) == pt(jpk.vk.kzg_vk.g)


def test_prover_matches_jax_and_host(keys):
    jc, tc, assign, public, jpk, pk, tpk = keys
    prover = TorchPlonkProver(pk, device="cpu")
    # the static columns interpolated on the device equal the key's
    assert [F.to_ints(p) for p in prover.sel_polys] == pk.selector_polys
    assert [F.to_ints(p) for p in prover.sig_polys] == pk.s_sigma_polys
    spans.enable()
    try:
        got = prover.prove(assign, public, tc, rng=random.Random(5))
    finally:
        spans.disable()
    traced, _counters = spans.drain()
    assert [sp.name for sp in sorted(traced, key=lambda sp: sp.t0)
            if sp.name.startswith("round.")] == [
        "round." + r for r in ("r1_wires", "r2_grand_product", "r3_quotient",
                               "r4_evals", "r5_open")]
    want = proof_fields(got)
    assert proof_fields(jax_backend.prove(jpk, assign, public, jc,
                                          rng=random.Random(5))) == want
    assert proof_fields(backend.prove(tpk, assign, public, tc,
                                      rng=random.Random(5))) == want
    assert proof_fields(JaxPlonkProver(jpk).prove(
        assign, public, jc, rng=random.Random(5))) == want
    assert backend.verify(pk.vk, got, public)
    bad = [(public[0] + 1) % R_MOD] + list(public[1:])
    assert not backend.verify(pk.vk, got, bad)


def test_preprocess_matches_jax_setup(keys):
    """The key preprocessed on the device (K2 interpolates, K3 commits)
    is the JAX package's `setup` key, point for point."""
    _jc, tc, _assign, _public, jpk, pk, _tpk = keys
    dpk, _prover = preprocess(tc.compile(), pk.srs, "cpu")
    vk, want = dpk.vk, jpk.vk
    assert [pt(c.point) for c in vk.comm_selectors + vk.comm_s_sigma] == \
        [pt(c.point) for c in want.comm_selectors + want.comm_s_sigma]
    assert (vk.n, vk.omega, tuple(vk.ks), vk.num_public) == (
        want.n, want.omega, tuple(want.ks), want.num_public)
    assert pt(vk.kzg_vk.g) == pt(want.kzg_vk.g)


def test_zk_off_matches_jax_unblinded(keys):
    """zk=False draws nothing and equals the JAX package's host prover
    with every blinding scalar 0, field for field."""
    jc, tc, assign, public, jpk, pk, _tpk = keys
    _dpk, prover = preprocess(tc.compile(), pk.srs, "cpu")
    got = prover.prove(assign, public, tc, rng=NoDraws(), zk=False)
    want = jax_backend.prove(jpk, assign, public, jc, rng=ZeroDraws())
    assert proof_fields(got) == proof_fields(want)


NO_JAX_PROVE = """
import random, sys
sys.modules['jax'] = None
sys.modules['aes_zero_knowledge_proof_circuit_tpu'] = None
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import (
    PlonkCircuit, prove, setup, verify)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
    TorchPlonkProver)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native)

c = PlonkCircuit()
z = c.public_input()
x, y = c.var(), c.var()
xy = c.mul(x, y)
x3 = c.add_const(x, 3)
s = c.add(xy, x3)
c.assert_equal(s, z)
assign = {x: 2, y: 9, xy: 18, x3: 5, s: 23}
public = [23]
pk = setup(c, srs=generate_srs_native(c.compile().n + 8, random.Random(3)))
proof = TorchPlonkProver(pk, device="cpu").prove(assign, public, c,
                                                 rng=random.Random(9))
assert proof == prove(pk, assign, public, c, rng=random.Random(9))
assert verify(pk.vk, proof, public)
assert not verify(pk.vk, proof, [(public[0] + 1) % R_MOD])
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib",
                                "aes_zero_knowledge_proof_circuit_tpu."))))
assert not loaded, loaded
print("plonk proved and verified")
"""


def test_prove_without_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_PROVE], cwd=ROOT,
                          env=one_thread_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("plonk proved and verified")
