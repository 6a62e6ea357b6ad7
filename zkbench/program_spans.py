"""The port's own spans and counters in a traced run, on the trace's clock.

The port records spans and counters of its own while its facility is on
(`aes_zero_knowledge_proof_circuit_tpu_torch/utils/spans.py`): the
request's root, the witness fill, each prove and its rounds, the host
sections, each MSM and NTT, and every place the host blocks on the card.
Each span is also a profiler annotation `zkaes.<name>|<id>`.

The metrics that read them declare `SPANS = HOOKS`: the tracer wraps its
own `call` and `stop` with them, so the hook on `call` switches the
facility on (once) before the traced stretch's first call and the hook on
`stop` switches it off and drains it as the stretch ends, and keeps the
profiler's events as the tracer reads them (the profiler exports its
trace once). `joined(run)` then puts each program span on the launches'
clock by its annotation, as `trace.py` does its own spans (`exact`); a
span with no annotation in the trace keeps its host times. Kernels belong
to a program span as they do to a benchmark span
(`Trace.kernels_by_span`). The first `joined` of a run also prints,
on standard error: the idle device time by the deepest program span open
at each moment of each gap; launches and device time by round; bytes
copied each way; the runtime's synchronizations inside `prove` spans
against the program's `card_waits`; the proofs' wall time split into host
work, card waits and what is left (the interpreter lock, in the batch
cells).

Against a port without the facility every reader reads None.
"""

from __future__ import annotations

import statistics
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from zkbench.trace import RUNTIME_CATS, Kernel, Span, Trace, merged

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
WAIT = "wait.card"
ROUND = "round."

_state: dict = {"tracer": None, "records": None, "counters": None,
                "events": None, "joined": None}


def _port():
    """The port's span facility, or None where the port has none."""
    try:
        from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _on_call(args, kwargs) -> str:
    """`Tracer.call(self, index, messages)`: the facility on, once a
    tracer, before its first traced call."""
    tracer, port = args[0], _port()
    if port is not None and _state["tracer"] is not tracer:
        _state.update(tracer=tracer, records=None, counters=None,
                      events=None, joined=None)
        port.drain()
        port.enable()
    return ""


def _on_stop(args, kwargs) -> str:
    """`Tracer.stop(self)`: the facility off and drained, and the events
    the tracer will parse kept as it parses them."""
    tracer, port = args[0], _port()
    if port is not None and port.enabled():
        port.disable()
        _state["records"], _state["counters"] = port.drain()
        parse = tracer._trace

        def keep(events):
            _state["events"] = events
            return parse(events)

        tracer._trace = keep
    return ""


TRACER = "zkbench.trace:Tracer"
HOOKS = (("zkaes.hook", TRACER, "call", _on_call),
         ("zkaes.hook", TRACER, "stop", _on_stop))


def thread_ids(native: int, ident: int):
    """The ids the trace may give a thread (`trace.thread_ids`)."""
    low = ident & 0xFFFFFFFF
    return (native, low, low - (1 << 32) if low >= 1 << 31 else low)


@dataclass
class Joined:
    """The program's spans of a traced stretch, on its clock."""
    trace: Trace               # the run's trace, with spans by program name
    spans: List[Span]          # one a record, in the records' order
    records: list              # the port's span records
    counters: Dict[str, int]
    syncs: List[Kernel]        # the runtime's synchronizations
    depth: Dict[int, int] = field(default_factory=dict)   # by span id

    @property
    def proofs(self) -> int:
        return self.trace.proofs

    def per_proof_ms(self, seconds: float) -> Optional[float]:
        return 1e3 * seconds / self.proofs if self.proofs else None

    def host_s(self, name: str) -> float:
        return sum(sp.end - sp.start for sp in self.trace.spans.get(name, ()))

    def outermost(self) -> list:
        """Each thread's outermost records: no parent, or a parent on
        another thread (the request's root on the caller, each `prove`
        on a pool thread)."""
        by_id = {r.id: r for r in self.records}
        return [r for r in self.records
                if r.parent not in by_id or by_id[r.parent].tid != r.tid]

    def host_cpu_s(self) -> float:
        """Thread CPU seconds of each thread's outermost spans, less that
        of the card waits inside them (a wait spins on its CPU)."""
        outer = self.outermost()
        mine = {id(r) for r in outer}
        work = sum(r.c1 - r.c0 for r in outer if r.name != WAIT)
        waits = sum(r.c1 - r.c0 for r in self.records
                    if r.name == WAIT and id(r) not in mine)
        return (work - waits) / 1e9


def joined(run) -> Optional[Joined]:
    """The program's spans of `run`'s traced stretch (computed once), or
    None where the run has none."""
    tr = getattr(run, "trace", None)
    records, tracer = _state["records"], _state["tracer"]
    if tr is None or not records or tracer is None:
        return None
    if _state["joined"] is None or _state["joined"][0] is not tr:
        if _state["events"] is None:
            return None
        j = join(tr, records, dict(_state["counters"] or {}),
                 _state["events"], tracer.calls)
        _state["events"] = None
        say_joined(j)
        _state["joined"] = (tr, j)
    return _state["joined"][1]


def join(tr: Trace, records, counters, events, calls) -> Joined:
    """Program spans on the trace's clock: the offset from the calls'
    `zkb.call|i` marks, as `Tracer._trace` takes it, and each span's start
    and end from its `zkaes.<name>|<id>` annotation."""
    offsets, marks, syncs = [], {}, []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name.startswith("zkb.call|"):
            index = int(name.split("|", 1)[1])
            if index in calls:
                offsets.append(e["ts"] - calls[index][0] * 1e6)
        elif cat == "user_annotation" and name.startswith("zkaes."):
            marks[int(name.rsplit("|", 1)[1])] = e
        elif cat in RUNTIME_CATS and name in SYNCS:
            syncs.append(e)
    off = statistics.median(offsets) if offsets else 0.0
    host = lambda ts: (ts - off) / 1e6  # noqa: E731
    spans, by_name = [], defaultdict(list)
    for r in records:
        e = marks.get(r.id)
        tids = thread_ids(r.tid, r.ident)
        if e is not None and offsets:
            sp = Span(r.name, "", host(e["ts"]),
                      host(e["ts"] + e.get("dur", 0)),
                      tids + (e.get("tid"),), r.id, True)
        else:
            sp = Span(r.name, "", r.t0 / 1e9, r.t1 / 1e9, tids, r.id, False)
        spans.append(sp)
        by_name[r.name].append(sp)
    program = Trace(tr.start, tr.end, tr.proofs, tr.kernels, tr.device,
                    dict(by_name), tr.samples)
    sync_list = [Kernel(e["name"], host(e["ts"]),
                        host(e["ts"] + e.get("dur", 0)), host(e["ts"]),
                        e.get("tid")) for e in syncs if offsets]
    j = Joined(program, spans, list(records), counters, sync_list)
    by_id = {r.id: r for r in records}
    for r in records:
        d, p = 0, by_id.get(r.parent)
        while p is not None:
            d, p = d + 1, by_id.get(p.parent)
        j.depth[r.id] = d
    return j


# -- what a traced run prints -------------------------------------------------


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def label(record) -> str:
    what = record.attrs.get("what") if record.name == WAIT else None
    return f"{record.name}({what})" if what else record.name


def idle_by_span(j: Joined) -> Counter:
    """Idle device seconds of the stretch by the deepest program span open
    on any thread at each moment (ties: the one that started last);
    "no program span" where none is open."""
    tr = j.trace
    busy = merged([(max(s, tr.start), min(e, tr.end)) for s, e in tr.device
                   if e > tr.start and s < tr.end])
    edges = [tr.start] + [x for iv in busy for x in iv] + [tr.end]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    points = []
    for sp, r in zip(j.spans, j.records):
        if sp.end > tr.start and sp.start < tr.end:
            points.append((sp.start, 1, r.id))
            points.append((sp.end, -1, r.id))
    for a, b in gaps:
        points.append((a, 0, None))
        points.append((b, 0, None))
    points.sort(key=lambda p: (p[0], p[1]))
    by_id = {r.id: (r, sp) for r, sp in zip(j.records, j.spans)}
    out: Counter = Counter()
    active: dict = {}
    g, last = 0, None
    for t, step, rid in points:
        if last is not None and t > last:
            lo, hi = last, t
            while g < len(gaps) and gaps[g][1] <= lo:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < hi:
                a, b = max(gaps[k][0], lo), min(gaps[k][1], hi)
                if b > a:
                    if active:
                        rec = max(active.values(), key=lambda rs: (
                            j.depth[rs[0].id], rs[1].start))[0]
                        out[label(rec)] += b - a
                    else:
                        out["no program span"] += b - a
                k += 1
        if step == 1:
            active[rid] = by_id[rid]
        elif step == -1:
            active.pop(rid, None)
        last = t
    return out


def say_joined(j: Joined) -> None:
    tr, proofs = j.trace, max(1, j.proofs)
    exact = sum(sp.exact for sp in j.spans)
    say(f"program spans: {len(j.spans)}, {exact} timed by their "
        f"annotation; counters {dict(sorted(j.counters.items()))}; "
        f"{proofs} proofs")
    idle = idle_by_span(j)
    total = sum(idle.values())
    say(f"idle device time by the deepest program span: {total:.6f} s of "
        f"{tr.window_s:.6f} s (device idle {tr.window_s - tr.busy_s():.6f})")
    for name, s in idle.most_common(16):
        say(f"  idle {name}: {s:.6f} s, {1e3 * s / proofs:.3f} ms a proof")
    names = sorted({r.name for r in j.records if r.name.startswith(ROUND)},
                   key=lambda n: min(sp.start for sp in tr.spans[n]))
    for name in names:
        found = tr.kernels_by_span(name)
        kernels = [k for _, ks in found for k in ks]
        host = sum(sp.end - sp.start for sp, _ in found)
        say(f"  {name}: {len(kernels) / proofs:.1f} launches, "
            f"{1e3 * sum(k.end - k.start for k in kernels) / proofs:.3f} "
            f"device ms, {1e3 * host / proofs:.3f} host ms a proof")
    for kind in ("msm", "ntt"):
        kernels = [k for _, ks in tr.kernels_by_span(kind) for k in ks]
        say(f"  {kind} spans: {len(tr.spans.get(kind, ()))}, "
            f"{1e3 * sum(k.end - k.start for k in kernels) / proofs:.3f} "
            f"device ms a proof in {len(kernels)} kernels")
    up, back = (j.counters.get(k, 0) / proofs
                for k in ("upload_bytes", "readback_bytes"))
    say(f"bytes a proof: upload {up:.0f}, readback {back:.0f}")
    say_syncs(j)
    say_split(j)


def say_syncs(j: Joined) -> None:
    """The runtime's synchronizations inside `prove` spans, against the
    program's card waits; those in no card wait by the deepest span."""
    proofs = max(1, j.proofs)
    sync_tr = Trace(j.trace.start, j.trace.end, j.proofs, j.syncs, [],
                    j.trace.spans, [])
    in_prove = {id(k) for _, ks in sync_tr.kernels_by_span("prove")
                for k in ks}
    in_wait = {id(k) for _, ks in sync_tr.kernels_by_span(WAIT) for k in ks}
    waits_in_prove = sum(r.name == WAIT and r.proof is not None
                         for r in j.records)
    say(f"runtime synchronizations: {len(j.syncs)} in the stretch, "
        f"{len(in_prove)} inside prove spans ({len(in_prove) / proofs:.1f} a "
        f"proof), {len(in_prove & in_wait)} of them inside card waits; "
        f"card_waits {j.counters.get('card_waits', 0)} "
        f"({j.counters.get('card_waits', 0) / proofs:.1f} a proof), "
        f"{waits_in_prove} inside prove spans")
    loose = Counter()
    for k in j.syncs:
        if id(k) in in_prove and id(k) not in in_wait:
            loose[deepest_at(j, k.launch, k.tid)] += 1
    for where, n in loose.most_common(12):
        say(f"  synchronization in no card wait: {where}: {n}")
    waits = Counter(label(r) for r in j.records if r.name == WAIT
                    and r.proof is not None)
    say("  card waits in proves by place: " + ", ".join(
        f"{n} {c}" for n, c in waits.most_common()))


def deepest_at(j: Joined, t: float, tid) -> str:
    best = None
    for sp, r in zip(j.spans, j.records):
        if tid in sp.tids and sp.start <= t <= sp.end:
            if best is None or j.depth[r.id] > j.depth[best.id]:
                best = r
    return "no program span" if best is None else label(best)


def say_split(j: Joined) -> None:
    """Each proof's wall time: host work, card waits, and the rest."""
    proves = [(sp, r) for sp, r in zip(j.spans, j.records)
              if r.name == "prove"]
    if not proves:
        return
    wall = sum(sp.end - sp.start for sp, _ in proves)
    cpu = sum(r.c1 - r.c0 for _, r in proves) / 1e9
    waits = [(sp, r) for sp, r in zip(j.spans, j.records)
             if r.name == WAIT and r.proof is not None]
    wait_wall = sum(sp.end - sp.start for sp, _ in waits)
    wait_cpu = sum(r.c1 - r.c0 for _, r in waits) / 1e9
    rest = wall - (cpu - wait_cpu) - wait_wall
    n = len(proves)
    say(f"prove spans: {n}, wall {1e3 * wall / n:.3f} ms a proof = host "
        f"work {1e3 * (cpu - wait_cpu) / n:.3f} + card waits "
        f"{1e3 * wait_wall / n:.3f} + the rest {1e3 * rest / n:.3f} (not "
        f"on a CPU and not waiting on the card: the interpreter lock, the "
        f"scheduler); host CPU a second of the stretch "
        f"{j.host_cpu_s() / j.trace.window_s:.3f}")
    covered = []
    for sp, r in proves:
        inside = [s for s, q in zip(j.spans, j.records)
                  if q.proof == r.id and q.parent == r.id
                  and q.name.startswith(ROUND)]
        if sp.end > sp.start:
            covered.append(sum(s.end - s.start for s in inside)
                           / (sp.end - sp.start))
    say(f"rounds cover {100 * min(covered):.2f}-{100 * max(covered):.2f} % "
        f"of their prove spans")
