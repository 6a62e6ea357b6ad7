"""The native host library (zkhost) for this package, loaded under a lock.

The JAX package's `native.lib()` builds the library into the cache
directory on first use, with one temporary path for every process, and
turns any failure into a permanent None (a one-shot flag). Processes that
build at once on an empty cache can make each other fail, and the JAX
package then quietly takes its Python path. This package has no Python
path for the SRS generator or the native Pippenger, so every use of the
native module goes through `native()`:

1. the first load runs under an inter-process lock (`fcntl.flock` on
   `<cache>/native/.build.lock`), so one process builds while the others
   wait and then load the finished library;
2. if that load still returns None (the library was lost to a build race
   in a process that does not take the lock) and ZKAES_NO_NATIVE is unset,
   the one-shot flag is cleared and the load retried once under the lock;
3. if the retry fails too, `NativeUnavailable` is raised with the reason.
"""

from __future__ import annotations

import fcntl
import logging
import os
from pathlib import Path

from aes_zero_knowledge_proof_circuit_tpu import native as _native
from aes_zero_knowledge_proof_circuit_tpu.utils.config import CONFIG

class NativeUnavailable(RuntimeError):
    """The native zkhost library could not be built or loaded."""


class _Reasons(logging.Handler):
    """Collects the warnings the JAX loader logs when a load fails."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


def _locked_load(lock_path: Path) -> bool:
    with open(lock_path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if _native.lib() is not None:
                return True
            _native._TRIED = False
            return _native.lib() is not None
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def native():
    """The JAX package's `native` module with its library loaded. Raises
    NativeUnavailable when it cannot be loaded; never falls back."""
    if _native._LIB is not None:
        return _native
    if os.environ.get("ZKAES_NO_NATIVE"):
        raise NativeUnavailable("native zkhost library unavailable: "
                                "ZKAES_NO_NATIVE is set")
    lock_dir = Path(CONFIG.cache_dir) / "native"
    lock_dir.mkdir(parents=True, exist_ok=True)
    reasons = _Reasons()
    _native.log.addHandler(reasons)
    try:
        ok = _locked_load(lock_dir / ".build.lock")
    finally:
        _native.log.removeHandler(reasons)
    if not ok:
        why = "; ".join(reasons.messages) or "no reason logged"
        raise NativeUnavailable(f"native zkhost library unavailable: {why}")
    return _native
