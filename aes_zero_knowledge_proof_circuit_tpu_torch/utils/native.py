"""The native host library (native/zkhost.cpp), built, loaded and bound.

The library is built on demand with g++ into `<cache>/native/` as
`libzkhost_torch_<cpu>.so` (a name of its own: no other package's build is
ever loaded) and bound through ctypes. `lib()` returns None when it cannot
be built or loaded, and the converters below then return None too.

Processes that build at once on an empty cache could make each other fail,
and this package has no Python path for the SRS generator or the native
Pippenger, so callers go through `native()`:

1. the first load runs under an inter-process lock (`fcntl.flock` on
   `<cache>/native/.build.lock`), so one process builds while the others
   wait and then load the finished library;
2. if that load still returns None (the library was lost to a build race
   in a process that did not take the lock) and ZKAES_NO_NATIVE is unset,
   the one-shot flag is cleared and the load retried once under the lock;
3. if the retry fails too, `NativeUnavailable` is raised with the reason.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import CONFIG

log = logging.getLogger(__name__)

_SRC = str(Path(__file__).resolve().parent.parent / "native" / "zkhost.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class NativeUnavailable(RuntimeError):
    """The native zkhost library could not be built or loaded."""


def _build_dir() -> str:
    d = str(Path(CONFIG.cache_dir) / "native")
    os.makedirs(d, exist_ok=True)
    return d


def _cpu_tag() -> str:
    """-march=native output is host-specific: the library is keyed by the
    CPU's flag set, so another machine rebuilds instead of loading it."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith("flags")][:1]
        return hashlib.blake2s((platform.machine() + "".join(flags)).encode(),
                               digest_size=6).hexdigest()
    except OSError:
        return platform.machine()


def lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ZKAES_NO_NATIVE"):
            return None
        try:
            so = os.path.join(_build_dir(), f"libzkhost_torch_{_cpu_tag()}.so")
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(_SRC)):
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = ["g++", "-O3", "-march=native", "-funroll-loops",
                       "-shared", "-fPIC", "-std=c++17",
                       "-fopenmp", _SRC, "-o", tmp]
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=120)
                except subprocess.CalledProcessError:
                    cmd.remove("-fopenmp")  # toolchains without libgomp
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=120)
                os.replace(tmp, so)
            cdll = ctypes.CDLL(so)
            cdll.zk_g1_msm.restype = ctypes.c_int
            u64p = ctypes.POINTER(ctypes.c_uint64)
            cdll.zk_g1_msm.argtypes = [u64p, ctypes.POINTER(ctypes.c_uint8),
                                       u64p, ctypes.c_size_t, u64p]
            cdll.zk_g1_scale_base.restype = ctypes.c_int
            cdll.zk_g1_powers_fixed_base.restype = ctypes.c_int
            cdll.zk_g1_batch_normalize.restype = ctypes.c_int
            if cdll.zk_version() != 1:
                raise RuntimeError("zkhost ABI version mismatch")
            _LIB = cdll
        except Exception as e:  # no compiler / build failure
            log.warning("native zkhost unavailable (%s)", e)
            _LIB = None
        return _LIB


def available() -> bool:
    return lib() is not None


class _Reasons(logging.Handler):
    """Collects the warnings `lib()` logs when a load fails."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


def _locked_load(lock_path: Path) -> bool:
    global _TRIED
    with open(lock_path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if lib() is not None:
                return True
            _TRIED = False
            return lib() is not None
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def native():
    """This module with its library loaded. Raises NativeUnavailable when it
    cannot be loaded; never falls back."""
    module = sys.modules[__name__]
    if _LIB is not None:
        return module
    if os.environ.get("ZKAES_NO_NATIVE"):
        raise NativeUnavailable("native zkhost library unavailable: "
                                "ZKAES_NO_NATIVE is set")
    reasons = _Reasons()
    log.addHandler(reasons)
    try:
        ok = _locked_load(Path(_build_dir()) / ".build.lock")
    finally:
        log.removeHandler(reasons)
    if not ok:
        why = "; ".join(reasons.messages) or "no reason logged"
        raise NativeUnavailable(f"native zkhost library unavailable: {why}")
    return module


# -- converters ---------------------------------------------------------------

def _int_to_limbs(v: int, n: int) -> List[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def _limbs_to_int(row: np.ndarray) -> int:
    v = 0
    for x in reversed(row.tolist()):
        v = (v << 64) | int(x)
    return v


def pack_points(points) -> Tuple[np.ndarray, np.ndarray]:
    """Affine points -> (n,12) u64 canonical + (n,) u8 infinity flags."""
    n = len(points)
    arr = np.zeros((n, 12), np.uint64)
    inf = np.zeros(n, np.uint8)
    for i, p in enumerate(points):
        if p.inf:
            inf[i] = 1
            continue
        arr[i, :6] = _int_to_limbs(p.x, 6)
        arr[i, 6:] = _int_to_limbs(p.y, 6)
    return arr, inf


def pack_scalars(scalars: Sequence[int]) -> np.ndarray:
    out = np.zeros((len(scalars), 4), np.uint64)
    for i, s in enumerate(scalars):
        out[i] = _int_to_limbs(int(s), 4)
    return out


def _jacobian_out(out: np.ndarray):
    """The library's [18] u64 Jacobian result -> affine point."""
    from ..ops.curve_host import g1_infinity, g1_point
    from ..ops.field_params import Q_MOD, inv_mod

    z = _limbs_to_int(out[12:18])
    if z == 0:
        return g1_infinity()
    zinv = inv_mod(z, Q_MOD)
    zinv2 = zinv * zinv % Q_MOD
    x = _limbs_to_int(out[0:6]) * zinv2 % Q_MOD
    y = _limbs_to_int(out[6:12]) * zinv2 * zinv % Q_MOD
    return g1_point(x, y)


def g1_msm(points, scalars: Sequence[int]):
    """Pippenger MSM over affine points; returns AffinePoint or None when
    the native library is unavailable."""
    cdll = lib()
    if cdll is None or not points:
        return None
    packed = getattr(points, "packed", None)
    if packed is not None:      # utils/srs.PackedPowers: no per-point packing
        return g1_msm_packed(packed, pack_scalars(scalars))
    pts, inf = pack_points(points)
    return g1_msm_arrays(pts, inf, pack_scalars(scalars))


def g1_msm_arrays(pts: np.ndarray, inf: np.ndarray, scalars_u64: np.ndarray):
    """Pippenger MSM over points packed by `pack_points` and [n, 4] u64
    scalars below 2^256, in one call that runs outside the interpreter lock
    (ctypes releases it). Returns AffinePoint or None when the native
    library is unavailable."""
    cdll = lib()
    if cdll is None or pts.shape[0] == 0:
        return None
    n = pts.shape[0]
    if not (pts.dtype == np.uint64 and pts.shape == (n, 12)
            and inf.dtype == np.uint8 and inf.shape == (n,)
            and scalars_u64.dtype == np.uint64
            and scalars_u64.shape == (n, 4)
            and pts.flags.c_contiguous and inf.flags.c_contiguous
            and scalars_u64.flags.c_contiguous):
        raise ValueError("g1_msm_arrays takes contiguous [n, 12] u64 points, "
                         "[n] u8 flags and [n, 4] u64 scalars")
    out = np.zeros(18, np.uint64)
    rc = cdll.zk_g1_msm(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        inf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scalars_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_size_t(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    return _jacobian_out(out)


def g1_powers_fixed_base_packed(base, scalars: Sequence[int]):
    """[s * base for s in scalars] as a packed (n, 2, 24) uint32 16-bit-limb
    array (the SRS checkpoint layout; infinity rows are all-zero), or None.
    Uses 8-bit window tables + OpenMP — the SRS powers-of-tau generator."""
    cdll = lib()
    if cdll is None:
        return None
    bxy = np.zeros(12, np.uint64)
    bxy[:6] = _int_to_limbs(base.x, 6)
    bxy[6:] = _int_to_limbs(base.y, 6)
    sca = pack_scalars(scalars)
    out = np.zeros((len(scalars), 13), np.uint64)
    rc = cdll.zk_g1_powers_fixed_base(
        bxy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        sca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_size_t(len(scalars)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    # u64 limbs -> 16-bit limbs: view each u64 as 4 uint16s (little-endian)
    xy64 = out[:, :12].copy()  # (n, 12) u64
    inf = out[:, 12] != 0
    u16 = xy64.view(np.uint16).reshape(len(scalars), 2, 24)
    packed = u16.astype(np.uint32)
    packed[inf] = 0
    return packed


def g1_msm_packed(packed: np.ndarray, scalars_u64: np.ndarray,
                  window_bits: int = 0):
    """Pippenger MSM over [N, 2, 24] u32 16-bit-limb packed affine points
    (the SRS checkpoint layout) with [N, 4] u64 scalars. OpenMP windows.
    Returns AffinePoint or None when the native library is unavailable."""
    cdll = lib()
    if cdll is None or packed.shape[0] == 0:
        return None
    packed = np.ascontiguousarray(packed.astype(np.uint32))
    scalars_u64 = np.ascontiguousarray(scalars_u64.astype(np.uint64))
    out = np.zeros(18, np.uint64)
    rc = cdll.zk_g1_msm_limb16(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scalars_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_size_t(packed.shape[0]),
        ctypes.c_int(window_bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    return _jacobian_out(out)
