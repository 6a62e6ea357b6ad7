"""Run one cell of the port's benchmark once, and print its result.

    python3 zkbench/run.py --workload ecb16.single --seed 7 --seconds 30 \
        --trace 0

The cell (a `workloads` entry of BENCHMARK.json) names a configuration
(`zkbench/configs/`) and a traffic mix (`zkbench/traffic/`). The run:

1. sets the port's environment: its cache directory at a fixed path
   inside the checkout, one a configuration
   (`build/zkbench_cache/<config>_<digest of its file>/`), the allocator's
   expandable segments, the configuration's MSM engine;
2. exits with code 3 and prints no result when there is no CUDA card (or
   fewer than the cell asks for): the measurement never falls back to the
   CPU;
3. set-up (`setup_s`, from the process's start): the proving key
   (`api.synthesize_keys` from the configuration's SRS seed: built, on the
   card, and cached by the first run; loaded by later runs) and one warm
   call of the cell's own shape;
4. the window: calls of the mix, one after another (a closed loop), for
   `--seconds`; a call that starts inside the window is finished, and the
   window extends to its end. With `--trace 1` the first calls (at least
   `trace.TRACE_SECONDS` of them) run under the profiler, with spans and
   host samples;
5. reads the peak device memory, writes each proof's bytes, lets the
   program's key go, and judges every proof against the reference
   (`judge.py`): the run is `correct` when every count is within its
   limit;
6. prints the checks, each with its number and its limit, as the last
   lines of standard error, and one JSON object as the last line of
   standard output: `correct`, `attempted`, `failed`, `metrics` (the
   cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
   `device`, with `--trace 1` `breakdown`, and last `checks`.

It exits non-zero, with no result, if JAX or the JAX package has been
loaded into the process once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from collections import Counter, defaultdict

START = time.perf_counter()

from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench import judge as judge_mod  # noqa: E402
from zkbench import manifest, traffic  # noqa: E402
from zkbench.trace import TRACE_SECONDS, Trace, Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "aes_zero_knowledge_proof_circuit_tpu")
NO_CARD = 3


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window_s: float
    latencies: List[float]     # a call's, every call of the window
    attempted: int
    correct: int
    peak_bytes: int
    trace: Optional[Trace]


def process_age() -> float:
    """Seconds since this process started (Linux), else since START."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


def cache_dir(config: manifest.Config) -> Path:
    return ROOT / "build" / "zkbench_cache" / f"{config.name}_{config.digest}"


def set_environment(config: manifest.Config) -> None:
    """The port's settings for a run, before torch or the port loads."""
    from zkbench.program import MSM_ENV

    os.environ["ZKAES_CACHE_DIR"] = str(cache_dir(config))
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["ZKAES_MSM_MXU"] = MSM_ENV[config.msm_engine]
    os.environ.pop("ZKAES_PROOF_CONTAINER", None)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN
                  and sys.modules.get(m) is not None)


class Card:
    """The device calls of a run: the CUDA card, or (in tests, which skip
    the look for a card) nothing at all on the CPU."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"
        if self.cuda:
            import torch

            self.torch = torch

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            self.torch.cuda.empty_cache()

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(0) if self.cuda else "cpu"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             program, reference, setup_started: float,
             device: str = "cuda", scratch: Optional[Path] = None,
             imported: Optional[float] = None):
    """One run of `cell` on `program`, judged against `reference`: the
    result line's object, and the checks' lines for standard error.
    `setup_started` is the host time (perf_counter) set-up is counted
    from, `imported` the time torch had loaded and the card been found."""
    card = Card(device)
    mix, cfg = cell.mix, cell.config
    t0 = time.perf_counter()
    program.setup()
    t1 = time.perf_counter()
    for call in traffic.calls(mix, cfg.msg_len, seed, stream="warmup"):
        program.call(mix, call)
        break
    card.sync()
    t2 = time.perf_counter()
    setup_s = t2 - setup_started
    phases = ", ".join(f"{k} {v:.3f}" for k, v in
                       program.setup_times().items())
    loaded = ("" if imported is None else
              f" (torch and the card's look {imported - setup_started:.3f})")
    say(f"set-up {setup_s:.3f} s: before the key {t0 - setup_started:.3f}"
        f"{loaded},"
        f" the key {t1 - t0:.3f} ({phases}), the warm call {t2 - t1:.3f};"
        f" MSM engine {program.msm_engine()}, "
        f"{program.pipeline_depth(mix)} proof(s) in flight a call")

    modules = {m["name"]: manifest.metric_module(m["name"])
               for m in cell.metrics}
    tracer = None
    if trace:
        tracer = Tracer(modules.values(), scratch or Path("."))
        tracer.install()
        tracer.start()
    card.reset_peak()
    records: List[judge_mod.Record] = []
    calls = traffic.calls(mix, cfg.msg_len, seed)
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        call = next(calls)
        traced = tracer is not None and tracer.active
        ctx = (tracer.call(call.index, len(call.messages)) if traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        rec = judge_mod.Record(call, t0, t0)
        try:
            with ctx:
                rec.proofs = program.call(mix, call)
                card.sync()
        except Exception:  # noqa: BLE001 - counted; the window goes on
            rec.error = traceback.format_exc()
            say(f"call {call.index} failed:\n{rec.error}")
        rec.end = time.perf_counter()
        records.append(rec)
        if traced and rec.end - w0 >= TRACE_SECONDS:
            tracer.stop()
    window_s = records[-1].end - w0
    peak = card.peak()
    if tracer is not None and tracer.active:
        tracer.stop()

    for rec in records:
        if rec.proofs is not None:
            rec.proofs = [program.serialize(p) for p in rec.proofs]
    traced = None
    if tracer is not None:
        traced = tracer.read()
        tracer.uninstall()
    program.free()
    card.free()

    t0 = time.perf_counter()
    verdict = judge_mod.judge(records, reference, seed)
    lat = sorted(r.end - r.start for r in records)
    say(f"window {window_s:.3f} s, {len(records)} calls, "
        f"{verdict.attempted} messages; a call's seconds: min {lat[0]:.4f},"
        f" median {lat[len(lat) // 2]:.4f}, max {lat[-1]:.4f}; judged in "
        f"{time.perf_counter() - t0:.1f} s")
    run = Run(setup_s=setup_s, window_s=window_s,
              latencies=[r.end - r.start for r in records],
              attempted=verdict.attempted,
              correct=verdict.attempted - verdict.failed, peak_bytes=peak,
              trace=traced)
    metrics = {}
    for entry in cell.metrics:
        value = modules[entry["name"]].read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if card.cuda else "cpu", "kind": card.kind(),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
        say(f"traced {len(traced.kernels)} kernels over "
            f"{traced.window_s:.3f} s, {traced.proofs} proofs; "
            f"{sum(k.launch is None for k in traced.kernels)} kernels with "
            f"no launch found")
        for kind, spans in sorted(traced.spans.items()):
            say_spans(kind, spans, traced.kernels_by_span(kind))
    result["checks"] = verdict.checks()
    return result, verdict.lines()


def say_spans(kind, spans, found) -> None:
    """What the spans of one kind hold: kernels and device time, spans
    with no kernel, spans timed by the host clock, and by size."""
    inside = [k for _, ks in found for k in ks]
    names = Counter()
    for k in inside:
        names[k.name[:60]] += k.end - k.start
    say(f"spans {kind}: {len(spans)}, {len(inside)} kernels in them, "
        f"{sum(k.end - k.start for k in inside):.6f} device s; "
        f"{sum(not ks for _, ks in found)} with no kernel, "
        f"{sum(not sp.exact for sp in spans)} timed by the host clock; "
        f"most: " + "; ".join(f"{n} {t:.6f}" for n, t in
                              names.most_common(4)))
    sizes = defaultdict(lambda: [0, 0, 0.0])
    for sp, ks in found:
        row = sizes[sp.desc]
        row[0] += 1
        row[1] += len(ks)
        row[2] += sum(k.end - k.start for k in ks)
    for desc, (n, kernels, dev) in sorted(sizes.items(),
                                          key=lambda kv: -kv[1][2])[:8]:
        say(f"  {kind} {desc or '-'}: {n} spans, {kernels} kernels, "
            f"{1e3 * dev / n:.4f} device ms a span")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload, bool(args.trace))
    set_environment(cell.config)
    started = time.perf_counter() - process_age()

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"zkbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" found. The benchmark measures the card only.")
        return NO_CARD
    imported = time.perf_counter()
    from zkbench.program import Program
    from zkbench.reference import make_reference

    result, lines = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), Program(cell.config),
        make_reference(cell.config, cache_dir(cell.config)),
        setup_started=started, scratch=cache_dir(cell.config),
        imported=imported)
    found = forbidden_modules()
    if found:
        say(f"zkbench: the run loaded {found}; the port and the benchmark "
            f"run without JAX and without the JAX package")
        return 4
    say("card: " + card_line())
    for line in lines:
        say(line)
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi gave nothing"


if __name__ == "__main__":
    sys.exit(main())
