"""A whole run of the harness on the toy cell (the CPU path, the look for
a card skipped), with the program sound and with each fault planted
where its answers are produced; the measurement path without a card;
and the import guard."""

import json
import subprocess
import sys

import pytest

from zkbench import run
from zkbench.faults import Faulty
from zkbench.manifest import ROOT
from zkbench.tests import toy

SEED = 2**33 + 5


@pytest.fixture(scope="module")
def toy_pair():
    cell = toy.toy_cell()
    return toy.ToyProgram(cell.config), toy.ToyReference(cell.config)


def one_run(program, reference, traffic="single", seed=SEED):
    cell = toy.toy_cell(traffic)
    result, lines = run.run_cell(cell, seed, 0.01, False, program,
                                 reference, 0.0, device="cpu")
    assert len(lines) == len(result["checks"])
    json.dumps(result)                    # the result line is plain JSON
    return result


@pytest.mark.parametrize("traffic", ["single", "batch4"])
def test_a_sound_run_is_correct(toy_pair, traffic):
    result = one_run(*toy_pair, traffic)
    assert result["correct"] is True
    assert result["attempted"] == (1 if traffic == "single" else 4)
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in result["checks"].values())
    metrics = result["metrics"]
    assert metrics["proofs_per_s"]["value"] > 0
    assert metrics["setup_s"]["unit"] == "s"
    assert ("prove_s_p90" in metrics) == (traffic == "single")


@pytest.mark.parametrize("fault, traffic, count", [
    ("wrong_statement", "single", "unverified"),     # the control
    ("altered", "single", "unverified"),
    ("stale", "single", "unverified"),
    ("half", "batch4", "unverified"),
    ("no_zk", "single", "not_hiding"),
    ("no_zk", "batch4", "not_hiding"),
])
def test_a_planted_fault_is_not_correct(toy_pair, fault, traffic, count):
    program, reference = toy_pair
    result = one_run(Faulty(program, fault), reference, traffic)
    assert result["correct"] is False
    assert result["checks"][count]["value"] > result["checks"][count][
        "limit"]
    assert result["failed"] > 0


@pytest.mark.parametrize("strip", ["none", "comm_s", "s_at_beta1",
                                   "hiding_value"])
def test_hiding_needs_each_mask(toy_pair, strip):
    from zkbench.reference import S_INDEX, hiding
    from zkbench.ref import proof as ref_proof
    from zkbench.traffic import calls

    program, _reference = toy_pair
    cell = toy.toy_cell()
    proof = program.call(cell.mix, next(calls(cell.mix, toy.MSG_LEN, 3)))[0]
    parsed = ref_proof.parse(program.serialize(proof))
    if strip == "comm_s":
        parsed.comms[S_INDEX] = None
    elif strip == "s_at_beta1":
        parsed.evals_beta1[S_INDEX] = 0
    elif strip == "hiding_value":
        parsed.openings[0] = (parsed.openings[0][0], 0)
    assert hiding(parsed) is (strip == "none")


def test_a_failed_call_is_missing(toy_pair):
    program, reference = toy_pair

    class Failing:
        """The warm-up call succeeds; the window's first call raises."""

        def __init__(self):
            self.calls = 0

        def __getattr__(self, name):
            return getattr(program, name)

        def call(self, mix, call):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("planted")
            return program.call(mix, call)

    result = one_run(Failing(), reference)
    assert result["correct"] is False
    assert result["checks"]["missing"]["value"] == 1


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", "ecb16.single",
         "--seed", str(2**32 + 9), "--seconds", "1", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    if "needs 1 CUDA card" not in out.stderr:
        pytest.skip("a CUDA card is present")
    assert out.returncode == run.NO_CARD
    assert out.stdout.strip() == ""


GUARD = """
import sys
for name in ("jax", "jaxlib", "flax", "aes_zero_knowledge_proof_circuit_tpu"):
    sys.modules[name] = None
sys.argv = ["run.py"]
import zkbench.run, zkbench.program, zkbench.trace, zkbench.control
from zkbench import manifest
import zkbench.program as p
import aes_zero_knowledge_proof_circuit_tpu_torch.api
for m in manifest.load_manifest()["end_to_end"] + \\
        manifest.load_manifest()["per_layer"]:
    manifest.metric_module(m["name"])
loaded = sorted({m.split(".", 1)[0] for m, v in sys.modules.items()
                 if v is not None})
print(" ".join(loaded))
"""


def test_import_guard():
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "aes_zero_knowledge_proof_circuit_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    # the port's name begins with the JAX package's: only whole top-level
    # names count
    monkeypatch.setitem(sys.modules, "aes_zero_knowledge_proof_circuit_tpu_x",
                        sys)
    assert "aes_zero_knowledge_proof_circuit_tpu_x" not in \
        run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in run.forbidden_modules()
