"""Time the MSM kernels K3 and K4 of a tree on a CUDA card, kernel by kernel.

    python3 scripts/k3_variants.py build   # build the kernels only
    python3 scripts/k3_variants.py run

The script times the tree it sits in. To time a variant (other launch
bounds, another SEGMENT in ops/msm.py), copy the tree, edit the copy and run
the copy's script: each tree builds its own library under its own build/,
so several copies can `build` in parallel before their runs are timed one
after another.

`run` prints ptxas's registers and spills for each MSM kernel of the build,
checks K3 against its plain version at 1024 points (c = 6 and 13, with
repeated, negated and zero pairs) and against the native Pippenger at 2^16,
then prints the device milliseconds of each K3 kernel at 2^16, 2^19 and 2^20
points (torch.profiler, median of 3), K3's and msm_point's wall time
(median of 3), and K4's kernels at 2^20, with the card's name and power
limit. Points are the 2^16 native SRS powers repeated, scalars uniform
31-bit limbs from a seeded generator.
"""

from __future__ import annotations

import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch import kernels  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (  # noqa: E402
    msm as M,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (  # noqa: E402
    msm_device as MD,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (  # noqa: E402
    msm_pallas as MP,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import (  # noqa: E402
    fr_ops,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (  # noqa: E402
    generate_srs_native,
)

KERNEL_NAMES = ("segment_accumulate", "segment_merge", "bucket_reduce",
                "window_ladder", "lane_scan")


def profiled(label: str, fn) -> None:
    """Device ms of each MSM kernel in fn(), median of 3 profiled runs."""
    fn()
    torch.cuda.synchronize()
    res = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        tot = {}
        for e in p.events():
            if e.device_type.name != "CUDA":
                continue
            for k in KERNEL_NAMES:
                if k in e.name:
                    tot[k] = tot.get(k, 0.0) + (
                        e.time_range.end - e.time_range.start) / 1e3
        for k, v in tot.items():
            res.setdefault(k, []).append(v)
    med = {k: round(statistics.median(v), 3) for k, v in res.items()}
    print(label, med, "sum", round(sum(med.values()), 3), flush=True)


def wall_ms(fn, reps: int = 3) -> float:
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(ms), 3)


def check(base, packed, dev) -> None:
    f = fr_ops()
    rnd = random.Random(5)
    sc = [rnd.randrange(f.modulus) for _ in range(1 << 16)]
    small = base[:1024].clone()
    small[1], small[2] = small[0], small[3]
    s2 = sc[:1024]
    s2[1], s2[2], s2[4] = s2[0], f.modulus - s2[3], 0
    scalars = f.from_ints(s2, dev, mont=False)
    for c in (6, 13):
        mags, negs = M.signed_digits(scalars, c)
        args = (small, *M.bucket_runs(mags, negs, 1 << (c - 1)),
                mags.shape[0], 1 << (c - 1), c)
        got, want = M.bucket_msm(*args), M.plain_bucket_msm(*args)
        if any(M.xyzz_to_affine(g) != M.xyzz_to_affine(w)
               for g, w in zip(got, want)):
            raise AssertionError(f"K3 disagrees with plain at c={c}")
    full = f.from_ints(sc, dev, mont=False)
    if M.msm(base, full) != M.native_msm(packed, full):
        raise AssertionError("K3 disagrees with the native Pippenger")
    print("K3 equals plain (1024 points, c = 6, 13) and native (2^16)",
          flush=True)


def main() -> int:
    mode = sys.argv[1]
    t0 = time.perf_counter()
    lib = kernels.library()
    if mode == "build":
        print("built", lib.path.name, round(time.perf_counter() - t0, 1), "s",
              flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"=== {lib.path.name}, SEGMENT {M.SEGMENT}, on {smi}", flush=True)
    for src, name, regs, st, ld in kernels.resource_usage():
        if name in KERNEL_NAMES:
            print(f"ptxas {src} {name}: {regs} registers, spill stores {st} B,"
                  f" spill loads {ld} B", flush=True)
    dev = torch.device("cuda", 0)
    packed = generate_srs_native((1 << 16) - 1, random.Random(3)).powers_g1.packed
    base = M.points_from_packed(packed, dev)
    check(base, packed, dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for log_n in (16, 19, 20):
        n = 1 << log_n
        points = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
        s = torch.randint(0, 2**31, (n, 8), dtype=torch.int64,
                          generator=gen).to(torch.int32).to(dev)
        s[:, 7] &= 0x0fffffff
        c = M.window_bits(n)
        mags, negs = M.signed_digits(s, c)
        args = (points, *M.bucket_runs(mags, negs, 1 << (c - 1)),
                mags.shape[0], 1 << (c - 1), c)
        profiled(f"2^{log_n} K3", lambda: M.bucket_msm(*args))
        print(f"2^{log_n} K3 wall {wall_ms(lambda: M.bucket_msm(*args))} ms, "
              f"msm_point wall {wall_ms(lambda: M.msm_point(points, s))} ms",
              flush=True)
        if log_n == 20:
            plan = MP.land(MD.digit_limbs(s))
            profiled(f"2^{log_n} K4", lambda: MP.scan_msm(points, plan))
            same = M.xyzz_to_affine(M.bucket_msm(*args)[0]) == \
                M.xyzz_to_affine(MP.scan_msm(points, plan)[0])
            print("  K3 == K4:", same, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
