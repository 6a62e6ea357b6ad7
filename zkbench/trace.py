"""The traced run: the device's timeline, benchmark-side spans, host samples.

With `--trace 1` the harness profiles a stretch of whole calls at the
start of the window (`TRACE_SECONDS` or more: the calls that start
before it has passed), with `torch.profiler` (CPU and CUDA activities),
and meanwhile

- wraps the port's methods that the cell's metrics name (each metric's
  `SPANS`) so that every call of them records a span: its kind, a short
  description of its size, its thread and its start and end on the host
  clock;
- samples every thread's Python stack each `SAMPLE_S` seconds
  (`StackSampler`, a copy of the port's `scripts/profile_torch_prove.py`
  one, with times).

The trace holds the CUDA runtime's launches of every thread, each with
the kernel it queued (their correlation id), and, where torch has the
option (`all_threads`), every thread's CPU ops. The trace is put on the
host clock by the main thread's `zkb.call` annotations, one a call,
whose host start the harness also notes. Each span is an annotation too
(`zkb.span|<number>`), and takes its start and end from the trace's own
record of it, on the clock of the launches: a span of an NTT lasts tens
of microseconds on the host, about the error of aligning two clocks, so
host times would lose its launches at the edges. A span the trace holds
no record of keeps its host times (`Span.exact` false). A kernel belongs
to a span when the launch that queued it ran inside the span, on the
span's thread: the trace names a thread by its native id, or by the low
32 bits of its `pthread_self` (which may read as a signed number) where
it saw none of its CPU ops, and a span notes all three (`thread_ids`)
and the trace's own id of its annotation.
"""

from __future__ import annotations

import contextlib
import gzip
import importlib
import itertools
import json
import os
import statistics
import sys
import threading
import time
from bisect import bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

TRACE_SECONDS = 5.0
SAMPLE_S = 2e-3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
PKG_DIR = "aes_zero_knowledge_proof_circuit_tpu_torch"
# the frames a sample is labelled with besides its innermost one
OUTER_FILES = ("marlin/prover.py", "api.py")
# a thread whose innermost frame is here waits on another (the batch's
# caller on its proving threads): not a sample of host work
WAITING = ("threading.py", "concurrent/futures/_base.py")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _where(frame) -> str:
    return (f"{frame.f_code.co_name} "
            f"{frame.f_code.co_filename.split(PKG_DIR + '/')[-1]}:"
            f"{frame.f_lineno}")


def place(frame) -> Optional[str]:
    """Where a sampled stack is: its innermost frame of the port (function,
    file and line), the call it is in beyond the port, if any, and the
    prover's or the API's frame it was called from ("< ..."), if another;
    None outside the port or waiting on another thread."""
    inner = frame
    if inner.f_code.co_filename.endswith(WAITING):
        return None
    while frame is not None and PKG_DIR not in frame.f_code.co_filename:
        frame = frame.f_back
    if frame is None:
        return None
    where = _where(frame)
    if inner is not frame:
        where += f" in {inner.f_code.co_name}"
    outer = frame.f_back
    while outer is not None and not outer.f_code.co_filename.endswith(
            OUTER_FILES):
        outer = outer.f_back
    if outer is not None and not frame.f_code.co_filename.endswith(
            OUTER_FILES):
        where += f" < {_where(outer)}"
    return where


class StackSampler:
    """Samples every other thread's stack each `period` seconds while
    running: (host time, place) of each thread busy in the port (not one
    that waits on another thread)."""

    def __init__(self, period: float = SAMPLE_S):
        self.period = period
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            now = time.perf_counter()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                text = place(frame)
                if text is not None:
                    self.samples.append((now, text))

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def thread_ids() -> Tuple[int, ...]:
    """The ids the trace may give the calling thread: its native id, and
    the low 32 bits of its `pthread_self`, unsigned and signed."""
    low = threading.get_ident() & 0xFFFFFFFF
    return (threading.get_native_id(), low,
            low - (1 << 32) if low >= 1 << 31 else low)


@dataclass
class Span:
    kind: str
    desc: str
    start: float          # host seconds (perf_counter)
    end: float
    tids: Tuple[int, ...]  # thread_ids() of the thread it ran on
    mark: int = -1         # the number of its annotation
    exact: bool = False    # timed by the trace's record of its annotation


@dataclass
class Kernel:
    name: str
    start: float          # device start, host seconds
    end: float
    launch: Optional[float]   # the launch's host time
    tid: Optional[int]        # the launching thread, as the trace names it


@dataclass
class Trace:
    """A traced stretch, every time on the host clock (seconds)."""
    start: float
    end: float
    proofs: int
    kernels: List[Kernel]
    device: List[Tuple[float, float]]   # kernel and copy intervals
    spans: Dict[str, List[Span]]
    samples: List[Tuple[float, str]]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return busy_us([(max(s, self.start), min(e, self.end))
                        for s, e in self.device if e > self.start
                        and s < self.end])

    def kernels_in(self, kind: str) -> List[Kernel]:
        """The kernels launched inside a span of `kind`, on its thread."""
        return [k for k, sp in zip(self.kernels, self._owners(kind))
                if sp is not None]

    def kernels_by_span(self, kind: str) -> List[Tuple[Span, List[Kernel]]]:
        """Each span of `kind` with the kernels launched inside it."""
        spans = self.spans.get(kind, [])
        found: Dict[int, List[Kernel]] = {id(sp): [] for sp in spans}
        for k, sp in zip(self.kernels, self._owners(kind)):
            if sp is not None:
                found[id(sp)].append(k)
        return [(sp, found[id(sp)]) for sp in spans]

    def _owners(self, kind: str) -> List[Optional[Span]]:
        """For each kernel, the span of `kind` its launch ran in, or None.
        Threads that share a `pthread_self` (a pool's threads reuse those
        of the pool before) form one group, and the trace may name any of
        them by the id it saw first, so a span answers to every id of its
        group; a group's threads never run at once."""
        spans = self.spans.get(kind, [])
        group: Dict[int, set] = defaultdict(set)
        for sp in spans:
            group[sp.tids[1]].update(sp.tids)
        by_tid: Dict[int, List[Span]] = defaultdict(list)
        for sp in spans:
            for tid in group[sp.tids[1]]:
                by_tid[tid].append(sp)
        starts = {}
        for tid, spans in by_tid.items():
            spans.sort(key=lambda s: s.start)
            starts[tid] = [s.start for s in spans]
        out: List[Optional[Span]] = []
        for k in self.kernels:
            owner = None
            if k.launch is not None and k.tid in by_tid:
                spans = by_tid[k.tid]
                i = bisect_right(starts[k.tid], k.launch) - 1
                # spans of one kind do not nest on a thread; look one back
                for sp in spans[max(0, i - 1):i + 1]:
                    if sp.start <= k.launch <= sp.end:
                        owner = sp
                        break
            out.append(owner)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops: Counter = Counter()
        for k in self.kernels:
            ops[k.name] += k.end - k.start
        gaps: Counter = Counter()
        busy = merged([(max(s, self.start), min(e, self.end))
                       for s, e in self.device
                       if e > self.start and s < self.end])
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        samples = sorted(self.samples)
        times = [t for t, _ in samples]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            lo, hi = bisect_right(times, g0), bisect_right(times, g1)
            seen = Counter(p for _, p in samples[lo:hi])
            label = seen.most_common(1)[0][0] if seen else "no host sample"
            gaps[label] += g1 - g0
        return {"device_ops": [[n[:200], s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n[:200], s] for n, s in gaps.most_common(top)]}


def all_threads() -> dict:
    """The profiler's option to record every thread's CPU ops, where this
    torch has it, so that the trace names every launching thread by its
    native id."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _target(path: str):
    """The class that a "module:Class" path names."""
    module, _, qual = path.partition(":")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


class Tracer:
    """Spans, the profiler and the sampler of one traced stretch."""

    def __init__(self, metric_modules, scratch: Path):
        self.decls = {}
        for mod in metric_modules:
            for kind, target, method, describe in getattr(mod, "SPANS", ()):
                self.decls[(target, method)] = (kind, describe)
        self.scratch = Path(scratch)
        self.spans: List[Span] = []
        self.calls: Dict[int, Tuple[float, float]] = {}
        self.proofs = 0
        self._marks = itertools.count()
        self._saved = []
        self._prof = None
        self._sampler = None
        self.active = False

    # -- spans ---------------------------------------------------------------

    def install(self) -> None:
        for (target, method), (kind, describe) in self.decls.items():
            owner = _target(target)
            orig = getattr(owner, method)
            self._saved.append((owner, method, orig))
            setattr(owner, method, self._wrap(kind, describe, orig))

    def uninstall(self) -> None:
        for owner, method, orig in reversed(self._saved):
            setattr(owner, method, orig)
        self._saved.clear()

    def _wrap(self, kind, describe, orig):
        from torch.profiler import record_function

        tracer = self

        def traced(*args, **kwargs):
            if not tracer.active:
                return orig(*args, **kwargs)
            span = Span(kind, describe(args, kwargs), time.perf_counter(),
                        0.0, thread_ids(), next(tracer._marks))
            try:
                with record_function(f"zkb.span|{span.mark}"):
                    return orig(*args, **kwargs)
            finally:
                span.end = time.perf_counter()
                tracer.spans.append(span)
        return traced

    # -- the traced stretch ---------------------------------------------------

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             **all_threads())
        self._prof.start()
        self._sampler = StackSampler()
        self._sampler.start()
        self.active = True

    @contextlib.contextmanager
    def call(self, index: int, messages: int):
        from torch.profiler import record_function

        with record_function(f"zkb.call|{index}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.calls[index] = (t0, time.perf_counter())
                self.proofs += messages

    def stop(self) -> None:
        self.active = False
        self._sampler.stop()
        self._prof.stop()

    def read(self) -> Trace:
        """The profiler's trace, through its chrome-trace export (written
        under `scratch`, read and deleted)."""
        self.scratch.mkdir(parents=True, exist_ok=True)
        path = self.scratch / f"trace_{os.getpid()}.json"
        try:
            self._prof.export_chrome_trace(str(path))
            opener = gzip.open if path.read_bytes()[:2] == b"\x1f\x8b" \
                else open
            with opener(path, "rt") as f:
                events = json.load(f)
        finally:
            path.unlink(missing_ok=True)
        if isinstance(events, dict):
            events = events["traceEvents"]
        return self._trace(events)

    def _trace(self, events) -> Trace:
        offsets, runtime, marks = [], {}, {}
        for e in events:
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"].startswith("zkb.call|"):
                index = int(e["name"].split("|", 1)[1])
                if index in self.calls:
                    offsets.append(e["ts"] - self.calls[index][0] * 1e6)
            elif cat == "user_annotation" and e["name"].startswith(
                    "zkb.span|"):
                marks[int(e["name"].split("|", 1)[1])] = e
            elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
                runtime[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
        if not offsets:
            raise RuntimeError("the trace holds none of the calls' marks")
        off = statistics.median(offsets)
        host = lambda ts: (ts - off) / 1e6  # noqa: E731
        kernels, device = [], []
        for e in events:
            cat = e.get("cat")
            if cat not in DEVICE_CATS:
                continue
            s = host(e["ts"])
            t = s + e.get("dur", 0) / 1e6
            device.append((s, t))
            if cat == "kernel":
                launch = runtime.get(e.get("args", {}).get("correlation"))
                kernels.append(Kernel(
                    e["name"], s, t, host(launch[0]) if launch else None,
                    launch[1] if launch else None))
        spans: Dict[str, List[Span]] = defaultdict(list)
        for sp in self.spans:
            e = marks.get(sp.mark)
            if e is not None:
                sp.start = host(e["ts"])
                sp.end = host(e["ts"] + e.get("dur", 0))
                sp.tids = sp.tids + (e.get("tid"),)
                sp.exact = True
            spans[sp.kind].append(sp)
        start = min(t0 for t0, _ in self.calls.values())
        end = max(t1 for _, t1 in self.calls.values())
        return Trace(start, end, self.proofs, kernels, device, dict(spans),
                     self._sampler.samples)
