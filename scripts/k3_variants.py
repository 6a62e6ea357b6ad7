"""Time the MSM kernels K3 and K4 of a tree on a CUDA card, kernel by kernel.

    python3 scripts/k3_variants.py build   # build the kernels only
    python3 scripts/k3_variants.py run
    python3 scripts/k3_variants.py k4      # K4 only (checked against K3)
    python3 scripts/k3_variants.py e2e CACHE_DIR [REPS]   # index, proves

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
(median of 3), and K4's kernels, wall time and landing at 2^19 and 2^20
(its MSM held to K3's) and `msm_device_point`'s wall time, with the
card's name and power limit. Points are the 2^16 native SRS powers
repeated, scalars uniform 31-bit limbs from a seeded generator. `k4` runs
the K4 part alone.

`e2e` builds the 16-byte keys with the template and SRS cached in
CACHE_DIR (give every tree timed in one call the same directory: the SRS
is generated once), then times, in one process, the index itself
(`marlin.indexer.index`, its 9 K4 launches and the SRS upload), and warm
zk proves on the K3 and the K4 engine after a cold prove: the median of
REPS (3 by default) synchronized wall times each, and every time sorted.
The script runs unchanged in a copy of an older tree, so trees compare in
one call: run the trees in turns (A B B A ...) to see the spread.
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

# lane_scan: K4's former scan, so that the script also times older trees
KERNEL_NAMES = ("segment_accumulate", "segment_merge", "bucket_reduce",
                "window_ladder", "affine_level", "window_pairs", "lane_scan")


def profiled(label: str, fn) -> None:
    """Device ms of each MSM kernel in fn(), median of 3 profiled runs, and
    each launch of K4's affine levels in the last run."""
    fn()
    torch.cuda.synchronize()
    res = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        tot, levels = {}, []
        for e in p.events():
            if e.device_type.name != "CUDA":
                continue
            for k in KERNEL_NAMES:
                if k in e.name:
                    ms = (e.time_range.end - e.time_range.start) / 1e3
                    tot[k] = tot.get(k, 0.0) + ms
                    if k == "affine_level":
                        levels.append(round(ms, 3))
        for k, v in tot.items():
            res.setdefault(k, []).append(v)
    med = {k: round(statistics.median(v), 3) for k, v in res.items()}
    print(label, med, "sum", round(sum(med.values()), 3), flush=True)
    if levels:
        print(f"{label} affine levels (last run): {levels}", flush=True)


def wall_times(fn, reps: int = 3) -> list:
    """Sorted synchronized wall milliseconds of `reps` calls of fn()."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    return sorted(ms)


def wall_ms(fn, reps: int = 3) -> float:
    return statistics.median(wall_times(fn, reps))


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


def e2e(cache: str, reps: int, dev) -> None:
    import dataclasses
    import os

    from aes_zero_knowledge_proof_circuit_tpu_torch import api
    from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer

    api.CONFIG.cache_dir = cache
    pk, vk = api.synthesize_keys(16, device=dev)
    print("setup", {k: round(v, 3) for k, v in pk.setup_times.items()},
          flush=True)
    index = lambda: indexer.index(pk.template.r1cs, pk.marlin_pk.srs, dev)
    index()
    kernels.reset_counts()
    index()
    torch.cuda.synchronize()
    busy = {k: v for k, v in kernels.launch_counts().items() if v}
    ms = wall_times(index, reps)
    print(f"index (warm) {statistics.median(ms)} ms median of {reps} {ms}, "
          f"launches {busy}", flush=True)
    key, msg = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), bytes(16)
    for label, mxu in (("K3", "1"), ("K4", "0")):
        os.environ["ZKAES_MSM_MXU"] = mxu
        p = dataclasses.replace(pk, _prover=None, _witness=None)
        prove = lambda: api.encrypt(msg, key, p, rng=random.Random(2),
                                    zk=True)
        proof = prove()
        if not api.verify_encryption(vk, proof,
                                     api.compute_ciphertext(msg, key)):
            raise AssertionError(f"the {label}-engine proof does not verify")
        ms = wall_times(prove, reps)
        print(f"warm prove (zk, {label} engine, {p._prover.msm_engine}) "
              f"{statistics.median(ms)} ms median of {reps} {ms}", flush=True)


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
    if mode == "e2e":
        e2e(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 3, dev)
        return 0
    packed = generate_srs_native((1 << 16) - 1, random.Random(3)).powers_g1.packed
    base = M.points_from_packed(packed, dev)
    if mode == "run":
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
        if mode == "run":
            profiled(f"2^{log_n} K3", lambda: M.bucket_msm(*args))
            print(f"2^{log_n} K3 wall {wall_ms(lambda: M.bucket_msm(*args))} "
                  f"ms, msm_point wall "
                  f"{wall_ms(lambda: M.msm_point(points, s))} ms", flush=True)
        if log_n >= 19:
            d16 = MD.digit_limbs(s)
            plan = MP.land(d16)
            profiled(f"2^{log_n} K4", lambda: MP.scan_msm(points, plan))
            k4_ms = wall_ms(lambda: MP.scan_msm(points, plan))
            land_ms = wall_ms(lambda: MP.land(d16))
            device_ms = wall_ms(lambda: MD.msm_device_point(points, d16))
            print(f"2^{log_n} K4 wall {k4_ms} ms, land wall {land_ms} ms, "
                  f"msm_device_point wall {device_ms} ms", flush=True)
            if M.xyzz_to_affine(M.bucket_msm(*args)[0]) != \
                    M.xyzz_to_affine(MP.scan_msm(points, plan)[0]):
                raise AssertionError(f"K4 disagrees with K3 at 2^{log_n}")
            print("  K4 == K3", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
