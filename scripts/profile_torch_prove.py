"""Profile one warm 16-byte prove of the PyTorch port on a CUDA card.

    python3 scripts/profile_torch_prove.py [--warm 3] [--out FILE]

Builds the proving key on the card (`synthesize_keys(16, device="cuda")`,
cached on disk after the first run), runs `--warm` unprofiled proves, then
one prove under `torch.profiler` with CPU and CUDA activities. It prints:

- the card's name and power limit (nvidia-smi) and the warm prove seconds;
- the profiled prove's wall seconds and stage times;
- device busy seconds (the union of every device kernel and copy interval)
  and the device's idle share of the prove's wall time;
- one `[group]` line per kernel family (K1, K2, each K3 kernel, torch's
  scan and sort kernels, the rest): device ms, launches and share, each
  the sum of the `[kernel]` lines whose names it matches;
- one `[kernel]` line per device kernel or copy name, sorted by device time.

`--out` also writes the `[kernel]` lines to FILE.
"""

from __future__ import annotations

import argparse
import random
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch import api  # noqa: E402

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
MESSAGE = bytes(range(16))
# (group, substrings of the device kernel name), first match wins
GROUPS = (
    ("K1 field_binop", ("field_binop",)),
    ("K2 ntt_stage", ("ntt_stage",)),
    ("K3 segment_accumulate", ("segment_accumulate",)),
    ("K3 bucket_merge", ("bucket_merge",)),
    ("K3 bucket_chunk_reduce", ("bucket_chunk_reduce",)),
    ("K3 window_combine", ("window_combine",)),
    ("torch scan (cumsum)", ("scan",)),
    ("torch sort", ("Sort", "sort")),
    ("copies", ("Memcpy", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other torch kernels"


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


def prove(pk, seed: int):
    t0 = time.perf_counter()
    proof = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(seed), zk=True)
    torch.cuda.synchronize()
    return proof, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_prove: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    pk, vk = api.synthesize_keys(16, device=dev)
    print(f"synthesize_keys(16): {time.perf_counter() - t0:.1f}s", flush=True)
    prove(pk, 0)                                  # cold prove
    warm = [prove(pk, 1 + i)[1] for i in range(args.warm)]
    print("warm proves (s): " + ", ".join(f"{s:.3f}" for s in warm)
          + (f"; median {statistics.median(warm):.3f}" if warm else ""))

    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        proof, wall = prove(pk, 100)
    ct = api.compute_ciphertext(MESSAGE, KEY)
    if not api.verify_encryption(vk, proof, ct):
        raise AssertionError("the profiled proof does not verify")
    stages = pk._prover.last_stage_times
    print(f"profiled prove: {wall:.3f}s wall, verifies; stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()))

    per_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        per_name[e.name][0] += t - s
        per_name[e.name][1] += 1
    busy = busy_us(intervals) / 1e6
    if busy <= 0:
        raise AssertionError("the trace holds no device time")
    device_ms = sum(v[0] for v in per_name.values()) / 1e3
    print(f"device busy {busy:.4f}s of {wall:.4f}s wall: idle "
          f"{100 * (1 - busy / wall):.1f} %; device time summed over "
          f"kernels {device_ms:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    groups = defaultdict(lambda: [0.0, 0])
    for name, (us, calls) in per_name.items():
        g = groups[group_of(name)]
        g[0] += us
        g[1] += calls
    for name, (us, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[group] {name}: {us / 1e3:.3f} ms, {calls} launches, "
              f"{100 * us / 1e3 / device_ms:.1f} %")
    lines = [f"[kernel] {us / 1e3:.3f} ms, {calls} launches, "
             f"{group_of(name)}: {name[:160]}"
             for name, (us, calls) in sorted(per_name.items(),
                                             key=lambda kv: -kv[1][0])]
    print("\n".join(lines[:40]))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(smi + "\n" + "\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
