"""Builds, loads and launches the hand-written Hopper kernels.

Every `csrc/*.cu` file compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into a shared library
with a plain C interface, loaded with ctypes (no PyTorch headers). The
library lands in `build/torch_kernels/` at the repository root, named by a
hash of the sources, and is built on first use. ptxas's report of each
kernel's registers and spills lands beside it (`resource_usage()`).

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0 and counts
the launch otherwise, under a lock, so that counts stay exact while two
threads launch (`api.encrypt_batch` proves two messages at once). It
launches on the current CUDA device's current stream (the calling thread's),
so the wrappers first hold their tensors to that device (`check_device`).
Nothing is built or loaded on the CPU path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "zk_field_pow": [_P, _P, _P, _I, _LL, _I, _P],
    "zk_batch_inv": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
    "zk_ntt_pass": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "zk_msm_g1": [_P, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P, _P, _I, _P, _P],
    "zk_msm_u8": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                  _P, _P, _P, _I, _P, _P],
    "zk_fq_cols_mul": [_P, _P, _P, _LL, _P],
    "zk_srs_fixed_base": [_P, _P, _LL, _P, _P],
}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


class Kernel:
    """One C entry point of the library, with its launch count: each call
    adds the number of kernels the entry point launches."""

    def __init__(self, name: str, kernels_per_call: int = 1):
        self.name = name
        self.kernels_per_call = kernels_per_call
        self.launches = 0

    def __call__(self, *args) -> None:
        import torch

        fn = getattr(library().cdll, self.name)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise KernelError(f"{self.name} launch failed: CUDA error {err}")
        with _COUNT_LOCK:
            self.launches += self.kernels_per_call


def check_device(*tensors) -> None:
    """Raise ValueError for a CUDA tensor that is not on the current CUDA
    device: a kernel launches there, from raw pointers, and would read
    another card's memory across the bus or fault. CPU tensors pass."""
    import torch

    for t in tensors:
        if t.device.type == "cuda" and \
                t.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {t.device}, but the current CUDA "
                             f"device is cuda:{torch.cuda.current_device()}:"
                             f" launch under torch.cuda.device({t.device})")


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
_COUNT_LOCK = threading.Lock()    # every Kernel's launch count


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


def _run(procs) -> str:
    """Wait for every (name, Popen); raise with the errors of any that
    failed, else return their standard errors, each under `== name`."""
    errors, logs = [], []
    for name, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n"
                          f"{err[-4000:]}")
        logs.append(f"== {name}\n{err}")
    if errors:
        raise KernelError("\n".join(errors))
    return "\n".join(logs)


def _ptxas_log(so: Path) -> Path:
    return so.with_suffix(".ptxas.txt")


def _build(so: Path) -> None:
    """One nvcc per source, all at once, then one link into `so`; ptxas's
    verbose report of the compiles goes to _ptxas_log(so)."""
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        _ptxas_log(so).write_text(_run(procs))
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


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_LENGTH = re.compile(r"\d+")


def _demangle(name: str) -> str:
    """The kernel's own name, the last part of a mangled symbol's nested
    name (`_ZN<len><namespace><len><kernel>E...`); the symbol itself if it
    is not mangled."""
    if not name.startswith("_Z"):
        return name
    i, last = (3 if name.startswith("_ZN") else 2), name
    while m := _LENGTH.match(name, i):
        i = m.end() + int(m[0])
        last = name[m.end():i]
    return last


def resource_usage() -> list:
    """(source, kernel, registers, spill store bytes, spill load bytes) of
    every kernel of the loaded library, in ptxas's order, from the report of
    its build (empty for a library built before reports were kept)."""
    log = _ptxas_log(library().path)
    if not log.exists():
        return []
    rows, src, entry, spills = [], "", None, (0, 0)
    for line in log.read_text().splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif m := _ENTRY.search(line):
            entry, spills = _demangle(m[1]), (0, 0)
        elif entry and (m := _SPILL.search(line)):
            spills = (int(m[1]), int(m[2]))
        elif entry and (m := _REGS.search(line)):
            rows.append((src, entry, int(m[1]), *spills))
            entry = None
    return rows


# the kernels, one entry per source file; fr_ops counts the launches of
# mul, add, sub, pow and batch_inv (three kernels a call)
field_mul = Kernel("zk_field_mul")
field_add = Kernel("zk_field_add")
field_sub = Kernel("zk_field_sub")
field_pow = Kernel("zk_field_pow")
batch_inv = Kernel("zk_batch_inv", kernels_per_call=3)
ntt_pass = Kernel("zk_ntt_pass")
msm_g1 = Kernel("zk_msm_g1")
msm_u8 = Kernel("zk_msm_u8")
fq_cols_mul = Kernel("zk_fq_cols_mul")
srs_fixed_base = Kernel("zk_srs_fixed_base")

KERNELS: Dict[str, tuple] = {
    "fr_ops": (field_mul, field_add, field_sub, field_pow, batch_inv),
    "ntt": (ntt_pass,),
    "msm": (msm_g1,),
    "msm_u8": (msm_u8,),
    "fq_cols": (fq_cols_mul,),
    "srs": (srs_fixed_base,),
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset_counts()."""
    with _COUNT_LOCK:
        return {name: sum(k.launches for k in ks)
                for name, ks in KERNELS.items()}


def reset_counts() -> None:
    with _COUNT_LOCK:
        for ks in KERNELS.values():
            for k in ks:
                k.launches = 0
