"""The port's loader of its own native host library (utils/native.py,
native/zkhost.cpp): it recovers the library after a lost build race,
reports why when it cannot, processes that start at once on an empty cache
all load it, and it builds and loads a library file of its own name."""

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


def test_concurrent_first_loads_on_an_empty_cache(tmp_path):
    env = dict(os.environ, ZKAES_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("ZKAES_NO_NATIVE", None)
    code = ("from aes_zero_knowledge_proof_circuit_tpu_torch.utils.native "
            "import native\n"
            "lib = native()._LIB\n"
            "assert lib.zk_version() == 1\n"
            "assert 'libzkhost_torch_' in lib._name, lib._name\n"
            "print('loaded')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "loaded"
    built = sorted(f.name for f in (tmp_path / "cache" / "native").iterdir())
    assert [f for f in built if f.endswith(".so")] and not [
        f for f in built if f.endswith(".tmp")]
    # only the port's own library: nothing of another package was built
    assert all(f.startswith("libzkhost_torch_")
               for f in built if f.endswith(".so"))
