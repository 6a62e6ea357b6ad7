"""The harness with a configuration's proof system: the Plonk reference
(its key, proof bytes, verifier and mask check) on the toy Plonk cell, the
configurations' `proof_system`, and the Marlin path as it was."""

import json
import random
import subprocess
import sys

import pytest

from zkbench import judge, manifest, run
from zkbench.faults import Faulty
from zkbench.manifest import ROOT
from zkbench.program import Program
from zkbench.ref.aes import bits_lsb_first
from zkbench.ref.field import Q_MOD, R_MOD, sqrt_mod
from zkbench.ref.plonk import proof as plonk_proof
from zkbench.ref.plonk.verify import verify
from zkbench.tests import toy_plonk
from zkbench.traffic import Call, calls

SEEDS = [2**33 + 7, 2**31 + 11, 3_000_000_019]
MESSAGE, KEY = b"\x5a\xc3", bytes(range(16))


@pytest.fixture(scope="module")
def toy_pair():
    cell = toy_plonk.toy_cell()
    return (toy_plonk.ToyPlonkProgram(cell.config),
            toy_plonk.ToyPlonkReference(cell.config))


def one_run(program, reference, traffic="single", seed=SEEDS[0]):
    cell = toy_plonk.toy_cell(traffic)
    result, lines = run.run_cell(cell, seed, 0.01, False, program,
                                 reference, 0.0, device="cpu")
    assert len(lines) == len(result["checks"])
    json.dumps(result)
    return result


def as_ref(point):
    return None if point.inf else (point.x, point.y)


def test_reference_key_equals_the_port_setup(toy_pair):
    program, reference = toy_pair
    vk = program.pk.vk
    key = reference.key()
    assert [as_ref(c.point) for c in vk.comm_selectors + vk.comm_s_sigma] \
        == key.comms
    assert (vk.n, vk.omega, tuple(vk.ks), vk.num_public) == (
        key.n, key.omega, key.ks, key.num_public)


def test_key_round_trips_through_json(toy_pair):
    from zkbench.ref.plonk.key import PlonkRefKey

    _, reference = toy_pair
    key = reference.key()
    back = PlonkRefKey.from_json(json.loads(json.dumps(key.to_json())),
                                 toy_plonk.SRS_SEED)
    assert (back.log_n, back.omega, back.ks, back.num_public, back.comms,
            back.tau) == (key.log_n, key.omega, key.ks, key.num_public,
                          key.comms, key.tau)
    assert back.weights == key.weights


def test_proof_bytes_and_verifier(toy_pair):
    program, reference = toy_pair
    data = program.serialize(program._prove(MESSAGE, KEY, 11))
    assert len(data) == plonk_proof.SIZE and data[:8] == b"ZKAESPLK"
    parsed = plonk_proof.parse(data)
    assert plonk_proof.serialize(parsed) == data
    instance = reference.instance(MESSAGE, KEY)
    assert verify(reference.key(), instance, parsed)
    for i in (0, len(instance) - 1):
        bad = list(instance)
        bad[i] ^= 1
        assert not verify(reference.key(), bad, parsed)
    assert not verify(reference.key(), instance[:-1], parsed)
    for field in ("eval_zw", "eval_s1"):
        changed = plonk_proof.parse(data)
        setattr(changed, field, (getattr(changed, field) + 1) % R_MOD)
        assert not verify(reference.key(), instance, changed)
    swapped = plonk_proof.parse(data)
    swapped.w_zeta, swapped.w_zeta_omega = (swapped.w_zeta_omega,
                                            swapped.w_zeta)
    assert not verify(reference.key(), instance, swapped)


def off_curve_x() -> int:
    return next(x for x in range(2, 1000)
                if sqrt_mod(x ** 3 + 1, Q_MOD) is None)


@pytest.mark.parametrize("spoil", ["trailing", "short", "off_curve",
                                   "scalar_r", "magic", "version"])
def test_bad_bytes(toy_pair, spoil):
    program, reference = toy_pair
    data = bytearray(program.serialize(program._prove(MESSAGE, KEY, 12)))
    if spoil == "trailing":
        data += b"\x00"
    elif spoil == "short":
        data = data[:-1]
    elif spoil == "off_curve":
        data[12:60] = off_curve_x().to_bytes(48, "little")   # comm_a
    elif spoil == "scalar_r":
        at = 12 + 7 * 48                                    # eval_a
        data[at:at + 32] = R_MOD.to_bytes(32, "little")
    elif spoil == "magic":
        data[:8] = b"ZKAESTPU"
    else:
        data[8:12] = (2).to_bytes(4, "little")
    with pytest.raises(plonk_proof.ProofBytesError):
        plonk_proof.parse(bytes(data))
    rec = judge.Record(Call(0, [MESSAGE], KEY, 12), 0.0, 0.0,
                       proofs=[bytes(data)])
    verdict = judge.judge([rec], reference, SEEDS[0])
    assert verdict.counts["bad_bytes"] == 1 and not verdict.correct


@pytest.mark.parametrize("traffic", ["single", "batch4"])
def test_a_sound_run_is_correct(toy_pair, traffic):
    result = one_run(*toy_pair, traffic)
    assert result["correct"] is True
    assert result["attempted"] == (1 if traffic == "single" else 4)
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in result["checks"].values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault, traffic, count", [
    ("wrong_statement", "single", "unverified"),     # the control
    ("altered", "single", "unverified"),
    ("stale", "single", "unverified"),
    ("half", "batch4", "unverified"),
    ("no_zk", "single", "not_hiding"),
])
def test_a_planted_fault_is_not_correct(toy_pair, fault, traffic, count,
                                        seed):
    program, reference = toy_pair
    result = one_run(Faulty(program, fault), reference, traffic, seed)
    assert result["correct"] is False
    assert result["checks"][count]["value"] > result["checks"][count][
        "limit"]


@pytest.mark.parametrize("column", [None, 0, 1, 2])
def test_hiding_needs_each_wire_blinded(toy_pair, column):
    program, reference = toy_pair
    cell = toy_plonk.toy_cell()
    call = next(calls(cell.mix, toy_plonk.MSG_LEN, 3))
    message = call.messages[0]
    parsed = plonk_proof.parse(program.serialize(
        program.call(cell.mix, call)[0]))
    names = ("comm_a", "comm_b", "comm_c")
    if column is not None:
        setattr(parsed, names[column],
                reference.wire_commitments(message, call.key)[column])
    for sampled in (False, True):
        assert reference.hiding(parsed, message, call.key, sampled) is (
            column is None)


def test_an_unblinded_proof_commits_to_the_plain_columns(toy_pair):
    program, reference = toy_pair
    proof = program._prove(MESSAGE, KEY, 13, zk=False)
    parsed = plonk_proof.parse(program.serialize(proof))
    assert [parsed.comm_a, parsed.comm_b, parsed.comm_c] == \
        reference.wire_commitments(MESSAGE, KEY)
    assert parsed.comm_z == reference.z_commitment(MESSAGE, KEY, parsed)


def unblinded_z_proof(program, seed):
    """A proof whose wires are blinded and whose z is not."""
    public = bits_lsb_first(toy_plonk.xor(MESSAGE, KEY))
    return program.serialize(program.backend.prove(
        program.pk, toy_plonk.assignment(program.m, program.k, MESSAGE,
                                         KEY),
        public, program.circuit,
        rng=toy_plonk.ZeroDrawsAt(seed, toy_plonk.Z_DRAWS)))


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sampled_proof_needs_z_blinded(toy_pair, seed):
    program, reference = toy_pair
    data = unblinded_z_proof(program, seed)
    parsed = plonk_proof.parse(data)
    assert parsed.comm_z == reference.z_commitment(MESSAGE, KEY, parsed)
    assert reference.hiding(parsed, MESSAGE, KEY, sampled=False)
    assert not reference.hiding(parsed, MESSAGE, KEY, sampled=True)
    honest = plonk_proof.parse(program.serialize(
        program._prove(MESSAGE, KEY, seed)))
    assert reference.hiding(honest, MESSAGE, KEY, sampled=True)
    # a run of one proof samples it
    rec = judge.Record(Call(0, [MESSAGE], KEY, seed), 0.0, 0.0,
                       proofs=[data])
    verdict = judge.judge([rec], reference, seed)
    assert verdict.counts["not_hiding"] == 1 and not verdict.correct


@pytest.mark.parametrize("total", [1, 4, 9])
def test_the_judge_samples_one_proof_a_run(total):
    seen = []

    class Recording:
        fixed = 0

        def parse(self, data):
            return data

        def serialize(self, parsed):
            return parsed

        def instance(self, message, key):
            return [0, 1]

        def verify(self, instance, parsed):
            return instance == [0, 1]

        def hiding(self, parsed, message, key, sampled):
            seen.append(sampled)
            return True

    recs = [judge.Record(Call(i, [b"m"], KEY, i), 0.0, 0.0, proofs=[b"p"])
            for i in range(total)]
    assert judge.judge(recs, Recording(), SEEDS[1]).correct
    assert len(seen) == total and sum(seen) == judge.SAMPLE


# -- the configurations' proof system ----------------------------------------

ECB = {"ecb16": (16, 1604162026, "13350c96829e"),
       "ecb64": (64, 6404162026, "31d65b9e8c31")}


@pytest.mark.parametrize("name", sorted(ECB))
def test_the_marlin_configurations_load_as_before(name):
    msg_len, srs_seed, digest = ECB[name]
    cfg = manifest.load_config(name, ROOT / "zkbench" / "configs" /
                               f"{name}.json")
    assert cfg == manifest.Config(
        name=name, msg_len=msg_len, mode="ecb", msm_engine="mxu", zk=True,
        srs_seed=srs_seed, digest=digest)
    assert cfg.proof_system == "marlin"
    assert run.cache_dir(cfg) == (ROOT / "build" / "zkbench_cache" /
                                  f"{name}_{digest}")


def plonk_file(tmp_path, **changes):
    d = json.loads((ROOT / "zkbench" / "configs" / "ecb16.json").read_text())
    d.update(proof_system="plonk")
    d.update(changes)
    path = tmp_path / "plonk16.json"
    path.write_text(json.dumps(d))
    return path


def test_a_plonk_configuration_loads(tmp_path):
    cfg = manifest.load_config("plonk16", plonk_file(tmp_path))
    assert (cfg.proof_system, cfg.msg_len, cfg.mode, cfg.zk) == (
        "plonk", 16, "ecb", True)


@pytest.mark.parametrize("changes", [
    {"message_bytes": 32}, {"mode": "cbc"}, {"zk": False},
    {"proof_system": "groth16"}, {"msm_engine": "pallas"},
    {"msm_engine": "k9"}, {"proof_sytem": "plonk"}, {"srs_sed": 1}])
def test_load_config_refuses(tmp_path, changes):
    with pytest.raises(ValueError):
        manifest.load_config("plonk16", plonk_file(tmp_path, **changes))


class RecordingApi:
    """The port's API as `Program` calls it, recording synthesize_keys;
    its key's Marlin prover runs on K4 and batches two deep."""

    def __init__(self):
        self.calls = []

    def synthesize_keys(self, *args, **kwargs):
        self.calls.append((args, kwargs))

        class Prover:
            msm_engine = "pallas"

        class Key:
            setup_times = {"template": 0.0}
            _prover = Prover()

        return Key(), None

    def _batch_depth(self, key, prover, messages):
        return 2


@pytest.mark.parametrize("system", ["marlin", "plonk"])
def test_program_setup_calls_synthesize_keys(system):
    cfg = manifest.Config(name="c", msg_len=16, mode="ecb", msm_engine="mxu",
                          zk=True, srs_seed=1604162026, digest="d",
                          proof_system=system)
    program = Program(cfg)
    program.api = RecordingApi()
    program.setup()
    program.setup()                       # the key is kept
    [(args, kwargs)] = program.api.calls
    assert args[0] == 16
    assert args[1].getstate() == random.Random(1604162026).getstate()
    want = {"mode": "ecb", "device": "cuda"}
    if system == "plonk":
        want["proof_system"] = "plonk"
    assert kwargs == want
    # Marlin: the key's prover says; Plonk: K3, one proof in flight
    mix = toy_plonk.toy_cell("batch4").mix
    assert (program.msm_engine(), program.pipeline_depth(mix)) == (
        ("pallas", 2) if system == "marlin" else ("mxu", 1))
    assert program.setup_times() == {"template": 0.0}


def test_make_reference_picks_the_system(tmp_path):
    from zkbench.reference import (AesReference, PlonkReference,
                                   make_reference)

    marlin = manifest.load_config("ecb16", ROOT / "zkbench" / "configs" /
                                  "ecb16.json")
    ref = make_reference(marlin, tmp_path)
    assert type(ref) is AesReference and ref.path.name == (
        "ref_key_ecb16_13350c96829e_v1.json")
    plonk = manifest.load_config("plonk16", plonk_file(tmp_path))
    ref = make_reference(plonk, tmp_path)
    assert type(ref) is PlonkReference
    assert ref.path.name.startswith("ref_plonk_key_plonk16_")
    assert ref.instance(MESSAGE * 8, KEY) == [
        (b >> i) & 1 for b in ref.ciphertext(MESSAGE * 8, KEY)
        for i in range(8)]


def test_the_plonk_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "for m in ('aes_zero_knowledge_proof_circuit_tpu_torch', 'jax',"
            " 'aes_zero_knowledge_proof_circuit_tpu', 'torch'):\n"
            "    sys.modules[m] = None\n"
            "import zkbench.reference, zkbench.judge\n"
            "import zkbench.ref.plonk.aes_map, zkbench.ref.plonk.verify\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT))
    assert out.stdout.strip() == "ok", out.stderr


# -- the MSM metrics on Plonk's commitments ------------------------------------

def test_the_msm_spans_cover_plonk_commitments():
    import torch

    from zkbench.metrics import msm_ms_per_proof, msm_roofline_pct
    from zkbench.trace import _target

    decls = {(target, method): describe
             for kind, target, method, describe in msm_roofline_pct.SPANS
             if kind == "msm"}
    assert decls == {(t, m): d
                     for _k, t, m, d in msm_ms_per_proof.SPANS}
    for target, method in decls:
        assert callable(getattr(_target(target), method))
    describe = decls[(msm_ms_per_proof.PLONK, "_commit_batch")]
    polys = [torch.zeros(n, 8) for n in (1 << 19, (1 << 19) + 3)]
    assert describe((None, polys), {}) == f"{1 << 19}+{(1 << 19) + 3}"
    assert describe((None,), {"polys": polys[:1]}) == str(1 << 19)


def test_the_msm_roofline_sums_a_batch_span():
    from types import SimpleNamespace

    from zkbench.metrics.msm_roofline_pct import least_msm_seconds, read

    kernel = SimpleNamespace(start=0.0, end=2.0)
    spans = [(SimpleNamespace(desc="1024+2048"), [kernel]),
             (SimpleNamespace(desc="4096"), [kernel]),
             (SimpleNamespace(desc="8"), [])]
    trace = SimpleNamespace(kernels_by_span=lambda kind: spans)
    want = 100.0 * (least_msm_seconds(1024) + least_msm_seconds(2048)
                    + least_msm_seconds(4096)) / 4.0
    assert read(SimpleNamespace(trace=trace)) == pytest.approx(want, rel=0)
