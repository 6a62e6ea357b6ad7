"""The port stands alone: no module of it imports jax or the JAX package
`aes_zero_knowledge_proof_circuit_tpu`, even indirectly or inside a
function.

* every module (and chip_smoke.py) is imported in a fresh interpreter where
  both `import jax` and `import aes_zero_knowledge_proof_circuit_tpu` fail;
* an AST scan of every source file of the port, chip_smoke.py and the
  card scripts (profile_torch_prove.py, mesh_smoke.py,
  time_sharded_msm.py, reckon_1kb.py, time_field_ntt.py, time_batch.py,
  time_spans.py)
  finds no import that names either;
* the toy circuit is built, indexed, proved (zk=False, CPU) and verified by
  the port alone in such an interpreter;
* so are the CBC and batch paths of the API: the 16-byte CBC template, its
  batched witness fill with an iv, `encrypt(iv=...)` up to the prover,
  `verify_encryption(iv=...)` up to the verifier and `encrypt_batch`'s
  checks;
* and the forward step of `entry.py` on the CPU: the 16-byte template's
  ciphertext bits and residual 0;
* and the API's Plonk path: `synthesize_keys(proof_system="plonk")` with
  the stand-in circuit of tests/torch_threads.py, `encrypt`, the codec and
  `verify_encryption`.

The subprocesses that run torch work run with one intra-op thread
(`one_thread_env`), as every test process does."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import aes_zero_knowledge_proof_circuit_tpu_torch as port
from tests.torch_threads import one_thread_env

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "aes_zero_knowledge_proof_circuit_tpu"
BLOCK = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    f"sys.modules[{JAX_PACKAGE!r}] = None\n"
)


def port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def scanned_files():
    files = sorted(Path(port.__path__[0]).rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "profile_torch_prove.py",
                    ROOT / "scripts" / "mesh_smoke.py",
                    ROOT / "scripts" / "time_sharded_msm.py",
                    ROOT / "scripts" / "reckon_1kb.py",
                    ROOT / "scripts" / "time_field_ntt.py",
                    ROOT / "scripts" / "time_batch.py",
                    ROOT / "scripts" / "time_spans.py"]


def test_module_list_covers_the_slice():
    names = set(port_modules())
    for leaf in ("api", "convert", "kernels", "ops.field", "ops.ntt",
                 "ops.poly", "ops.witness", "ops.curve", "ops.msm",
                 "ops.msm_device", "ops.msm_pallas", "ops.msm_ntt_mul",
                 "utils.srs", "utils.native", "marlin.indexer",
                 "marlin.prover", "__main__", "marlin.verifier",
                 "models.aes_circuit", "ops.kzg", "utils.serialize",
                 "utils.transcript", "utils.device", "plonk",
                 "plonk.circuit", "plonk.aes_map", "plonk.backend",
                 "plonk.prover", "entry", "utils.spans"):
        assert f"{port.__name__}.{leaf}" in names


@pytest.mark.parametrize("module", port_modules() + ["chip_smoke"])
def test_imports_without_jax(module):
    code = BLOCK + (
        "import importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and (m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        f"{JAX_PACKAGE + '.'!r}))))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _foreign_imports(path: Path):
    """(line, name) of every import in `path` that names jax or the JAX
    package, at any depth (inside functions too)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", JAX_PACKAGE):
                bad.append((node.lineno, name))
    return bad


@pytest.mark.parametrize("path", scanned_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_the_jax_package(path):
    assert _foreign_imports(path) == []


def test_scan_sees_imports_inside_functions(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\n\ndef g():\n"
                 f"    from {JAX_PACKAGE}.ops import kzg\n"
                 "    import jax.numpy\n")
    assert _foreign_imports(f) == [(4, f"{JAX_PACKAGE}.ops"),
                                   (5, "jax.numpy")]


TOY_PROVE = BLOCK + """
import random
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import verifier
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import TorchProver
from aes_zero_knowledge_proof_circuit_tpu_torch.models.r1cs import R1CS
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.serialize import (
    deserialize_proof, serialize_proof)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native)

cs = R1CS()
out1, out2 = cs.new_instance_var(), cs.new_instance_var()
x, y, z = cs.new_witness_var(), cs.new_witness_var(), cs.new_witness_var()
cs.enforce({x: 1}, {y: 1}, {out1: 1})
cs.enforce({x: 1, y: 1}, {z: 1}, {out2: 1})
cs.enforce({x: 1}, {x: 1}, {z: 1})
cs = cs.finalized()
xv, yv = 3, 4
zv = xv * xv % R_MOD
inst = [1, xv * yv % R_MOD, (xv + yv) * zv % R_MOD]
na, nb, nc = cs.nnz()
srs = generate_srs_native(indexer.required_degree(
    cs.num_constraints, cs.num_variables, max(na, nb, nc)), random.Random(5))
pk = indexer.index(cs, srs, "cpu")
proof = TorchProver(pk, "cpu").prove(inst, [xv, yv, zv], zk=False)
back = deserialize_proof(serialize_proof(proof))
assert verifier.verify(pk.vk, inst, back)
bad = list(inst)
bad[1] = (bad[1] + 1) % R_MOD
assert not verifier.verify(pk.vk, bad, back)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib", "aes_zero_knowledge_proof_circuit_tpu."))))
assert not loaded, loaded
print("proved and verified")
"""


def test_toy_prove_without_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", TOY_PROVE], cwd=ROOT,
                          env=one_thread_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("proved and verified")


CBC_PATHS = BLOCK + """
import random
import torch
from aes_zero_knowledge_proof_circuit_tpu_torch import api

tpl = api._template_cached(16, "cbc")
key, iv = bytes(range(16)), bytes(range(16, 32))
msgs = [bytes(16), bytes(range(32, 48))]
ev = api.WitnessEvaluator(tpl.plan, "cpu")
zs = ev.evaluate_batch(api._witness_bits(tpl, msgs, key, iv))
n = tpl.r1cs.num_instance
for m, z in zip(msgs, zs):
    ct = api.compute_ciphertext(m, key, iv=iv)
    assert z[:n].tolist() == [1] + api.bits_lsb_first(iv + ct)


class Recorder:
    def prove(self, instance, witness, rng=None, zk=True):
        return instance


pk = api.AESProvingKey(marlin_pk=None, template=tpl,
                       device=torch.device("cpu"), _prover=Recorder())
inst = api.encrypt(msgs[1], key, pk, iv=iv)
api._verifier.verify = lambda vk, instance, proof: instance == inst
assert api.verify_encryption(None, None, api.compute_ciphertext(
    msgs[1], key, iv=iv), iv=iv)
try:
    api.encrypt_batch(msgs, key, pk)
except api.InvalidInputError:
    pass
else:
    raise AssertionError("encrypt_batch took a CBC key")
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib", "aes_zero_knowledge_proof_circuit_tpu."))))
assert not loaded, loaded
print("cbc paths ran")
"""


def test_cbc_and_batch_paths_without_the_jax_package(tmp_path):
    env = one_thread_env(ZKAES_CACHE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", CBC_PATHS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("cbc paths ran")


ENTRY = BLOCK + """
import torch
from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.entry import entry
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.aes_host import encrypt_ecb

forward, (msg, key) = entry(device="cpu")
message, secret = bytes(range(16)), bytes(range(16, 32))
ct_bits, residual = forward(torch.tensor(api.bits_lsb_first(message)),
                            torch.tensor(api.bits_lsb_first(secret)))
assert ct_bits.tolist() == api.bits_lsb_first(bytes(encrypt_ecb(message,
                                                                secret)))
assert int(residual) == 0
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib", "aes_zero_knowledge_proof_circuit_tpu."))))
assert not loaded, loaded
print("forward step ran")
"""


def test_entry_without_the_jax_package(tmp_path):
    env = one_thread_env(ZKAES_CACHE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", ENTRY], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("forward step ran")


PLONK_PATH = BLOCK + """
import random
from aes_zero_knowledge_proof_circuit_tpu_torch import api
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native)
from tests.torch_threads import CiphertextPairs

api.AesPlonkCircuit = CiphertextPairs
srs = generate_srs_native(256 + 5, random.Random(8))
key, vk = api.synthesize_keys(16, srs=srs, proof_system="plonk",
                              device="cpu")
message, secret = bytes(range(16)), bytes(range(16, 32))
proof = api.encrypt(message, secret, key, zk=False)
data = api.serialize_proof(proof)
assert len(data) == 636 and data[:8] == b"ZKAESPLK"
ct = api.compute_ciphertext(message, secret)
assert api.verify_encryption(vk, api.deserialize_proof(data), ct)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith(("jax.", "jaxlib", "aes_zero_knowledge_proof_circuit_tpu."))))
assert not loaded, loaded
print("plonk path ran")
"""


def test_plonk_path_without_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", PLONK_PATH], cwd=ROOT,
                          env=one_thread_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("plonk path ran")
