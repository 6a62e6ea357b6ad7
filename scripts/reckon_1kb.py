"""Device memory and time of K2, K3 and K4 at the sizes a 1 KB message needs.

    python3 scripts/reckon_1kb.py [--out FILE]

A 1 KB AES-128 ECB proof has n = |H| = 2^24, a largest matrix of k = 2^25,
round-2 and round-3 cosets of 2^26 and an SRS of degree 2^26 (8,857,976
constraints). An SRS that large takes about an hour to generate on the
host, so this script takes the 2^16 points of a test SRS (native
generator) tiled, as chip_smoke.py's kernel timings do, and random
reduced scalars drawn on the card. For each case it prints the time
(median of 3 synchronized wall-clock runs after a warm-up, the whole
entry point: digits, sort, landing, kernel, result on the device) and
`torch.cuda.max_memory_allocated()` above what was allocated before it:

- K2: one forward NTT (`ntt_engine(log_n).ntt`) at 2^22 and 2^24 ... 2^26,
  its twiddle tables included;
- K3: `msm.msm_point` (signed 13-bit windows) at 2^22 and 2^24 ... 2^26;
- K4: `msm_device.msm_device_point` (8-bit windows, batch-affine levels)
  at 2^22 ... 2^25, the index's commits at k = 2^25.

Each MSM case prints its window groups (`msm.window_groups` at the
module's PAIR_BYTES and msm.GROUP_BYTES): one group up to 2^22, seven
for K3 at 2^26 (ten at 2^26 + 1) and eight for K4 at 2^25.

K4's MSM is held equal to K3's wherever both run. A case that runs out of
the card's memory is reported with the allocation that failed, and the
script goes on. It exits non-zero without a CUDA device or when a point
disagrees. `--out` also writes the lines to FILE.
"""

from __future__ import annotations

import argparse
import gc
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import ntt as N  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fr_ops  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (  # noqa: E402
    generate_srs_native,
)

NTT_LOGS = (22, 24, 25, 26)
K3_LOGS = (22, 24, 25, 26)
K4_LOGS = (22, 23, 24, 25)
LINES = []


def say(text: str) -> None:
    LINES.append(text)
    print(text, flush=True)


def gib(nbytes: int) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def random_scalars(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """[n, 8] reduced standard-form Fr limbs (top limb below r's)."""
    f = fr_ops()
    x = torch.randint(-2**31, 2**31, (n, f.L), dtype=torch.int32,
                      generator=gen, device=dev)
    top = f.modulus >> (32 * (f.L - 1))
    x[:, -1] = torch.randint(0, top, (n,), dtype=torch.int32, generator=gen,
                             device=dev)
    return x


def measure(label: str, make, run, dev, card: str):
    """Time run(*make()) and its peak memory above the memory allocated
    before make(); (the result of the last run, or None when the card's
    memory ran out)."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        args = make()
        out = run(*args)                  # warm-up (tables, first launch)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = run(*args)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) - before
        say(f"[{label}] {statistics.median(ms):.3f} ms (median of 3), peak "
            f"{gib(peak)} above the {gib(before)} held before [{card}]")
        return out.cpu()
    except torch.cuda.OutOfMemoryError as e:
        peak = torch.cuda.max_memory_allocated(dev) - before
        first = str(e).splitlines()[0]
        say(f"[{label}] out of memory after a peak of {gib(peak)} above the "
            f"{gib(before)} held before: {first} [{card}]")
        return None
    finally:
        args = out = None
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("reckon_1kb: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    free, total = torch.cuda.mem_get_info(dev)
    say(f"[card] {card}; {gib(total)} device memory, {gib(free)} free")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    for log_n in NTT_LOGS:
        def make(log_n=log_n):
            return (N.ntt_engine(log_n, dev),
                    random_scalars(1 << log_n, gen, dev))
        measure(f"K2 NTT 2^{log_n}", make, lambda eng, x: eng.ntt(x), dev,
                card)
        N._engine.cache_clear()

    t0 = time.perf_counter()
    srs = generate_srs_native((1 << 16) - 1, random.Random(3))
    base = M.points_from_packed(srs.powers_g1.packed, dev)
    say(f"[points] 2^16 test SRS points from the native generator "
        f"{time.perf_counter() - t0:.1f}s (host), tiled below")

    def inputs(log_n: int):
        n = 1 << log_n
        points = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
        g = torch.Generator(device=dev)
        g.manual_seed(log_n)
        return points, random_scalars(n, g, dev)

    def groups(windows: int, log_n: int, pair_bytes: int) -> str:
        return str(M.window_groups(windows, 1 << log_n, pair_bytes,
                                   M.GROUP_BYTES))

    k3 = {}
    for log_n in K3_LOGS:
        say(f"[K3 msm_point 2^{log_n}] window groups "
            f"{groups(M.n_windows(M.window_bits(1 << log_n)), log_n, M.PAIR_BYTES)}")
        k3[log_n] = measure(f"K3 msm_point 2^{log_n}",
                            lambda log_n=log_n: inputs(log_n), M.msm_point,
                            dev, card)
    bad = []
    for log_n in K4_LOGS:
        say(f"[K4 msm_device_point 2^{log_n}] window groups "
            f"{groups(MP.WINDOWS, log_n, MP.PAIR_BYTES)}")
        got = measure(
            f"K4 msm_device_point 2^{log_n}",
            lambda log_n=log_n: inputs(log_n),
            lambda pts, sc: MD.msm_device_point(pts, MD.digit_limbs(sc)),
            dev, card)
        want = k3.get(log_n)
        if got is not None and want is not None:
            same = M.xyzz_to_affine(got) == M.xyzz_to_affine(want)
            say(f"[K4 msm_device_point 2^{log_n}] MSM "
                f"{'equal to' if same else 'DIFFERS from'} K3's")
            if not same:
                bad.append(log_n)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(LINES) + "\n")
    if bad:
        raise AssertionError(f"K4 and K3 disagree at 2^{bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
