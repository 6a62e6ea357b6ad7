"""Time the point-sharded MSM on the visible cards, and see whether the
cards work at once.

    python3 scripts/time_sharded_msm.py [--log-n 22] [--shards 4]

On `make_mesh(SHARDS, "cuda")` (cuda:(i mod the card count)), with points
tiled from a 2^16-point native SRS and random scalars made on the card,
for each engine (K3 "mxu", K4 "pallas") it prints, as medians of 3 after a
warm-up, synchronized:

- one device: the whole MSM on cuda:0;
- each shard alone: the shard's MSM on its card, one card at a time;
- `msm_sharded` (the shards queued one after another from the calling
  thread), and the same shards run from a host thread a card, both
  checked equal to the one-device MSM;
- for one traced run of each of the last two, each card's first and last
  device activity and busy milliseconds, relative to the run's start
  (`torch.profiler`), so that overlap, or its absence, shows.

Prints the cards' name and power limit first. Exits non-zero without a
card or when a sum differs.
"""

from __future__ import annotations

import argparse
import random
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.curve_host import (  # noqa: E402
    g1_infinity,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel import (  # noqa: E402
    sharded_msm as SM,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import (  # noqa: E402
    chunk_bounds,
    make_mesh,
    on_device,
    replicated,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (  # noqa: E402
    generate_srs_native,
)


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def timed(fn, reps: int = 3):
    fn()
    ms = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


def threaded(mesh, replicas, scalars, engine):
    """The shards of msm_sharded, each from a host thread of its own, then
    folded on the host."""
    chunks = [(d, replicas[i][lo:hi], scalars[lo:hi].to(d))
              for i, (d, (lo, hi)) in enumerate(zip(
                  mesh.devices, chunk_bounds(scalars.shape[0], mesh.size)))
              if lo < hi]

    def run(d, pts, sc):
        with on_device(d):
            return SM._partial(pts, sc, engine)

    with ThreadPoolExecutor(len(chunks)) as pool:
        partials = [f.result() for f in [pool.submit(run, *c)
                                         for c in chunks]]
    total = g1_infinity()
    for p in partials:
        total = total.add(M.xyzz_to_affine(p)[0])
    return M.affine_to_xyzz(total, mesh.first)


def traced(fn) -> str:
    """Each card's first and last activity and busy ms in one run."""
    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    spans = defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans[e.device_index].append((e.time_range.start,
                                          e.time_range.end))
    if not spans:
        raise AssertionError("the trace holds no device time")
    start = min(s for v in spans.values() for s, _ in v)
    out = []
    for d, v in sorted(spans.items()):
        busy, end = 0.0, float("-inf")
        for s, t in sorted(v):
            busy += max(0.0, t - max(s, end))
            end = max(end, t)
        out.append(f"cuda:{d} {(min(s for s, _ in v) - start) / 1e3:.1f}"
                   f"-{(end - start) / 1e3:.1f} ms busy {busy / 1e3:.1f}")
    return f"wall {wall:.1f} ms; " + ", ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sharded_msm: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; {torch.cuda.device_count()} cards", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = 1 << args.log_n
    base = M.points_from_packed(
        generate_srs_native((1 << 16) - 1, random.Random(3)).powers_g1.packed,
        dev)
    points = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
    f = fr_ops()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    scalars = torch.randint(-2**31, 2**31, (n, f.L), dtype=torch.int32,
                            generator=g, device=dev)
    scalars[:, -1] = torch.randint(0, f.modulus >> (32 * (f.L - 1)), (n,),
                                   dtype=torch.int32, generator=g, device=dev)
    mesh = make_mesh(args.shards, "cuda")
    replicas = replicated(mesh, points)
    print(f"mesh {[str(d) for d in mesh.devices]}, 2^{args.log_n} points",
          flush=True)
    for engine in SM.ENGINES:
        one_ms, want = timed(lambda: SM._partial(points, scalars, engine))
        alone = []
        for i, (d, (lo, hi)) in enumerate(zip(
                mesh.devices, chunk_bounds(n, mesh.size))):
            sc = scalars[lo:hi].to(d)

            def shard():
                with on_device(d):
                    return SM._partial(replicas[i][lo:hi], sc, engine)
            alone.append(f"{d} {timed(shard)[0]:.1f}")
        turn_ms, got = timed(
            lambda: SM.msm_sharded(mesh, replicas, scalars, engine))
        threads_ms, got2 = timed(
            lambda: threaded(mesh, replicas, scalars, engine))
        for x in (got, got2):
            if M.xyzz_to_affine(x)[0] != M.xyzz_to_affine(want)[0]:
                raise AssertionError(f"{engine}: a sharded sum differs")
        print(f"[{engine}] one device {one_ms:.1f} ms; each shard alone "
              f"(ms): {', '.join(alone)}; msm_sharded (in turn) "
              f"{turn_ms:.1f} ms; a thread a card {threads_ms:.1f} ms; equal "
              f"[{smi}]", flush=True)
        print(f"[{engine}] traced msm_sharded: " + traced(
            lambda: SM.msm_sharded(mesh, replicas, scalars, engine)))
        print(f"[{engine}] traced a thread a card: " + traced(
            lambda: threaded(mesh, replicas, scalars, engine)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
