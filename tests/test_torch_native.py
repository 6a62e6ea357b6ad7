"""The port's loader of its own native host library (utils/native.py,
native/zkhost.cpp): it recovers the library after a lost build race,
reports why when it cannot, processes that start at once on an empty cache
all load it, and it builds and loads a library file of its own name. The
port tests' helper for the JAX package's native SRS survives the same race
(tests/torch_threads.jax_srs)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from aes_zero_knowledge_proof_circuit_tpu_torch.utils import native as loader

ROOT = Path(__file__).resolve().parent.parent


def test_recovers_after_a_lost_race(monkeypatch):
    monkeypatch.delenv("ZKAES_NO_NATIVE", raising=False)
    # the state the loader is left in when its build lost a race
    monkeypatch.setattr(loader, "_TRIED", True)
    monkeypatch.setattr(loader, "_LIB", None)
    assert loader.lib() is None
    assert loader.native() is loader
    assert loader._LIB is not None
    assert loader._LIB.zk_version() == 1


def test_raises_with_the_reason(monkeypatch, tmp_path):
    monkeypatch.delenv("ZKAES_NO_NATIVE", raising=False)
    monkeypatch.setattr(loader, "_TRIED", False)
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setattr(loader, "_SRC", str(tmp_path / "missing.cpp"))
    with pytest.raises(loader.NativeUnavailable, match="missing.cpp"):
        loader.native()


def test_raises_when_disabled(monkeypatch):
    monkeypatch.setenv("ZKAES_NO_NATIVE", "1")
    monkeypatch.setattr(loader, "_TRIED", False)
    monkeypatch.setattr(loader, "_LIB", None)
    with pytest.raises(loader.NativeUnavailable, match="ZKAES_NO_NATIVE"):
        loader.native()


def run_at_once(code: str, cache: Path, count: int, timeout: float):
    """Start `count` processes running `code` together on the cache `cache`
    and wait for all; (process, (stdout, stderr)) pairs."""
    env = dict(os.environ, ZKAES_CACHE_DIR=str(cache), JAX_PLATFORMS="cpu")
    env.pop("ZKAES_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(count)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return list(zip(procs, results))


def test_concurrent_first_loads_on_an_empty_cache(tmp_path):
    code = ("from aes_zero_knowledge_proof_circuit_tpu_torch.utils.native "
            "import native\n"
            "lib = native()._LIB\n"
            "assert lib.zk_version() == 1\n"
            "assert 'libzkhost_torch_' in lib._name, lib._name\n"
            "print('loaded')\n")
    for p, (out, err) in run_at_once(code, tmp_path / "cache", 3, 120):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "loaded"
    built = sorted(f.name for f in (tmp_path / "cache" / "native").iterdir())
    assert [f for f in built if f.endswith(".so")] and not [
        f for f in built if f.endswith(".tmp")]
    # only the port's own library: nothing of another package was built
    assert all(f.startswith("libzkhost_torch_")
               for f in built if f.endswith(".so"))


def test_concurrent_jax_srs_on_an_empty_cache(tmp_path):
    """Six processes that start at once on an empty cache each ask the
    helper for the JAX package's native SRS, whose loader builds its library
    under one shared temporary name: all six get an SRS whose first two
    powers are g and tau g."""
    code = ("import random\n"
            "from aes_zero_knowledge_proof_circuit_tpu.ops.curve_host import "
            "g1_generator\n"
            "from aes_zero_knowledge_proof_circuit_tpu.ops.field_params "
            "import R_MOD\n"
            "from tests.torch_threads import jax_srs\n"
            "srs = jax_srs(7, 5)\n"
            "tau = random.Random(5).randrange(1, R_MOD)\n"
            "g = g1_generator()\n"
            "assert srs.powers_g1[0] == g\n"
            "assert srs.powers_g1[1] == g.mul_scalar(tau)\n"
            "print('srs')\n")
    for p, (out, err) in run_at_once(code, tmp_path / "cache", 6, 300):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "srs"
    built = [f.name for f in (tmp_path / "cache" / "native").iterdir()]
    assert [f for f in built if f.endswith(".so")]
