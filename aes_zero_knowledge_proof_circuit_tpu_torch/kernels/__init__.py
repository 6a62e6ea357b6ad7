"""Builds, loads and launches the hand-written Hopper kernels.

Every `csrc/*.cu` file compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers). The
library lands in `build/torch_kernels/` at the repository root, named by a
hash of the sources, and is built on first use.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0 and counts
the launch otherwise. Nothing is built or loaded on the CPU path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C signatures: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "zk_field_mul": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "zk_field_add": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "zk_field_sub": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "zk_ntt_stage": [_P, _P, _LL, _LL, _P],
    "zk_msm_g1": [_P, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _I, _P, _P, _P,
                  _P, _P],
    "zk_msm_u8": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "zk_fq_cols_mul": [_P, _P, _P, _P, _LL, _P],
}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __call__(self, *args) -> None:
        import torch

        fn = getattr(library().cdll, self.name)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise KernelError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1


class _Library:
    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_LOCK = threading.Lock()
_LIB: Optional[_Library] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run(procs) -> None:
    """Wait for every (name, Popen); raise with the errors of any that
    failed."""
    errors = []
    for name, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n"
                          f"{err[-4000:]}")
    if errors:
        raise KernelError("\n".join(errors))


def _build(so: Path) -> None:
    """One nvcc per source, all at once, then one link into `so`."""
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        _run(procs)
        _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *[str(o) for o in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, so)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)


def library() -> _Library:
    """The loaded kernel library, built from `csrc/` on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.blake2s(digest_size=8)
        for src in _sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libzkaes_kernels_{h.hexdigest()}.so"
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _build(so)
            seconds = time.perf_counter() - t0
        _LIB = _Library(so, seconds)
        return _LIB


# the kernels, one per source file; fr_ops counts mul, add and sub launches
field_mul = Kernel("zk_field_mul")
field_add = Kernel("zk_field_add")
field_sub = Kernel("zk_field_sub")
ntt_stage = Kernel("zk_ntt_stage")
msm_g1 = Kernel("zk_msm_g1")
msm_u8 = Kernel("zk_msm_u8")
fq_cols_mul = Kernel("zk_fq_cols_mul")

KERNELS: Dict[str, tuple] = {
    "fr_ops": (field_mul, field_add, field_sub),
    "ntt": (ntt_stage,),
    "msm": (msm_g1,),
    "msm_u8": (msm_u8,),
    "fq_cols": (fq_cols_mul,),
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset_counts()."""
    return {name: sum(k.launches for k in ks) for name, ks in KERNELS.items()}


def reset_counts() -> None:
    for ks in KERNELS.values():
        for k in ks:
            k.launches = 0
