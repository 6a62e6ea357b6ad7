"""Spans and counters of the proving path: where a request's host time
goes and which kernels each part of it launched.

Off by default; `enable()` and `disable()` switch it, from code only. Off,
`span()` checks one module flag and returns the shared no-op `OFF`: no
lock, no annotation, nothing recorded. On, a span records its name, id,
parent's id (the innermost span open on its thread, or one given), the
request and proof it belongs to, its thread (native id and ident), its
`perf_counter_ns` and `thread_time_ns` at start and end, and its attrs;
and it is a `torch.profiler.record_function` annotation
`zkaes.<name>|<id>`, so that under the profiler it lands in the trace
beside the launches it holds, on their clock. No span synchronizes
anything: a span's device time is that of the kernels launched inside it.

Finished spans wait in a buffer of at most MAX_SPANS (the oldest dropped,
and counted); `drain()` hands over the spans and the counters and clears
both. The spans the port opens:

    api.encrypt, api.encrypt_batch   a request's root (sets its request id)
    witness.fill                     the witness fill of a request
    prove                            one proof (sets its proof id)
    round.<stage>                    the stages of a prove, end to end
    host.mask_draw                   the zk masks drawn on the host
    host.hiding                      the hiding terms' host MSMs, computed
                                     while the card runs their batch's MSMs
    host.transcript                  absorbs and challenges between rounds
    msm, ntt                         one MSM, one transform
    wait.card                        the host blocked on the card

and the counters: `card_waits` (the `wait.card` spans), `upload_bytes` and
`readback_bytes` (the bytes those waits copied), `hiding_terms` and
`hiding_terms_python` (the hiding terms computed by the native library and
by the Python fallback, ops/kzg.hiding_terms), `dropped_spans`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import torch

MAX_SPANS = 1 << 20
REQUESTS = ("api.encrypt", "api.encrypt_batch")
PROOF = "prove"

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: deque = deque(maxlen=MAX_SPANS)
_counters: Counter = Counter()
_dropped = 0


class _Off:
    """What every call returns while the facility is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, _stage):
        pass

    def set(self, **_attrs):
        pass


OFF = _Off()


def _thread():
    """This thread's stack of open spans and its (native id, ident)."""
    try:
        return _local.stack, _local.ids
    except AttributeError:
        _local.stack = []
        _local.ids = (threading.get_native_id(), threading.get_ident())
        return _local.stack, _local.ids


class Span:
    """One span; `set` adds attrs while it is open."""

    __slots__ = ("name", "id", "parent", "request", "proof", "tid", "ident",
                 "t0", "t1", "c0", "c1", "attrs", "_given", "_rf")

    def __init__(self, name: str, parent: Optional["Span"], attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.attrs = attrs
        self._given = parent
        self.t0 = self.t1 = self.c0 = self.c1 = 0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack, (self.tid, self.ident) = _thread()
        parent = self._given or (stack[-1] if stack else None)
        self.parent = None if parent is None else parent.id
        self.request = self.id if self.name in REQUESTS else (
            None if parent is None else parent.request)
        self.proof = self.id if self.name == PROOF else (
            None if parent is None else parent.proof)
        self._rf = torch.profiler.record_function(
            f"zkaes.{self.name}|{self.id}")
        self._rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.c1 = time.thread_time_ns()
        self.t1 = time.perf_counter_ns()
        stack = _thread()[0]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._rf.__exit__(*exc)
        self._rf = self._given = None
        _record(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, proof={self.proof}, "
                f"{(self.t1 - self.t0) / 1e6:.3f} ms, {self.attrs})")


def _record(sp: Span) -> None:
    global _dropped
    if not _on:
        return
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(sp)


def span(name: str, parent: Optional[Span] = None, **attrs):
    """A span of `name` as a context manager (OFF while off)."""
    if not _on:
        return OFF
    return Span(name, parent, attrs)


def wait(what: str, upload: int = 0, readback: int = 0):
    """A `wait.card` span around a place where the host blocks on the card
    (a copy of `upload` or `readback` bytes, or a stream's end), counted
    in `card_waits` and the byte counters."""
    if not _on:
        return OFF
    with _lock:
        _counters["card_waits"] += 1
        if upload:
            _counters["upload_bytes"] += upload
        if readback:
            _counters["readback_bytes"] += readback
    return Span("wait.card", None, {"what": what,
                                    "bytes": upload or readback})


def count(name: str, n: int) -> None:
    """Add n to the counter `name` (nothing while off)."""
    if not _on:
        return
    with _lock:
        _counters[name] += n


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _Rounds:
    """The stages of one prove as `round.<stage>` spans, each ending where
    the next begins: calling it with a stage's name ends the open round
    and opens the next; leaving the block ends the last. On a CUDA device
    a round's end reads the allocator (no synchronization): `allocated`
    and `peak` bytes, the card's, so every prove in flight on it counts."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.open: Optional[Span] = None

    def __enter__(self):
        return self

    def __call__(self, stage: str) -> None:
        self._end(None, None, None)
        if _on:
            self.open = Span("round." + stage, None, {}).__enter__()

    def __exit__(self, *exc):
        self._end(*exc)
        return False

    def _end(self, *exc) -> None:
        sp, self.open = self.open, None
        if sp is None:
            return
        if self.cuda:
            sp.set(allocated=torch.cuda.memory_allocated(self.device),
                   peak=torch.cuda.max_memory_allocated(self.device))
        sp.__exit__(*exc)


def rounds(device):
    """The round spans of a prove on `device` (OFF while off)."""
    if not _on:
        return OFF
    return _Rounds(device)


class _Attach:
    """A span of another thread as this thread's innermost, so that spans
    opened here are its children."""

    def __init__(self, parent: Span):
        self.parent = parent

    def __enter__(self):
        _thread()[0].append(self.parent)
        return self.parent

    def __exit__(self, *exc):
        stack = _thread()[0]
        if self.parent in stack:
            stack.remove(self.parent)
        return False


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    if not _on:
        return None
    stack = _thread()[0]
    return stack[-1] if stack else None


def attach(parent: Optional[Span]):
    """Open spans on this thread under `parent` (a span of another
    thread, from `current()` there)."""
    if not _on or parent is None:
        return OFF
    return _Attach(parent)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The finished spans, oldest first, and the counters (with
    `dropped_spans` where the buffer overflowed); both cleared."""
    global _dropped
    with _lock:
        out = list(_spans)
        _spans.clear()
        counters = dict(_counters)
        _counters.clear()
        if _dropped:
            counters["dropped_spans"] = _dropped
        _dropped = 0
    return out, counters
