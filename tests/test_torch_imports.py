"""No module of the port imports jax, even indirectly: every module (and
chip_smoke.py) is imported in a fresh interpreter where `import jax`
fails."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import aes_zero_knowledge_proof_circuit_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent


def port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def test_module_list_covers_the_slice():
    names = set(port_modules())
    for leaf in ("api", "convert", "kernels", "ops.field", "ops.ntt",
                 "ops.poly", "ops.witness", "ops.curve", "ops.msm",
                 "ops.msm_device", "ops.msm_pallas", "ops.msm_ntt_mul",
                 "utils.srs", "utils.native", "marlin.indexer",
                 "marlin.prover", "__main__"):
        assert f"{port.__name__}.{leaf}" in names


@pytest.mark.parametrize("module", port_modules() + ["chip_smoke"])
def test_imports_without_jax(module):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and (m == 'jax' or m.startswith(('jax.', 'jaxlib'))))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
