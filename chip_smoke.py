"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the Hopper kernels from `aes_zero_knowledge_proof_circuit_tpu_torch/
   csrc/` (one nvcc call), with the build time;
3. kernels: K1 (field mul/add/sub), K2 (NTT stage) and K3 (MSM buckets)
   against their plain PyTorch versions on the card, bit-exact, plus K3
   against the native host Pippenger; kernel and plain times (synchronized,
   median of 3) at the main path's shapes, where the timed outputs of kernel
   and plain version are compared as well;
4. main path: synthesize_keys(16) on the card, a zk proof of one AES-128
   block, verification (and rejection of a flipped ciphertext bit), a proof
   serialization round trip, and a warm prove with its stage times and the
   launches of each kernel.

The second-to-last line of stdout is the nvidia-smi line; before it a JSON
line with one entry per kernel. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import fq_ops, fr_ops
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native,
)

PKG = "aes_zero_knowledge_proof_circuit_tpu_torch"
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
MESSAGE = bytes(range(16))
KERNEL_INFO = {
    "fr_ops": ("csrc/fr_ops.cu",
               "aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py:151"),
    "ntt": ("csrc/ntt.cu",
            "aes_zero_knowledge_proof_circuit_tpu/ops/pallas_field.py:192"),
    "msm": ("csrc/msm.cu",
            "aes_zero_knowledge_proof_circuit_tpu/ops/msm_mxu.py:320"),
}


def say(*args) -> None:
    print(*args, flush=True)


def timed(fn, reps: int = 3):
    """(median wall milliseconds of fn() with the card synchronized, the
    result of the last call)."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def fold_err(entry: dict, err: int) -> None:
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0), err)


def random_elements(f, n: int, gen: np.random.Generator, dev) -> torch.Tensor:
    """n uniform-ish reduced elements (top limb below the modulus's) plus the
    edge rows 0, 1, p - 1 and R mod p."""
    limbs = gen.integers(0, 1 << 32, size=(n, f.L), dtype=np.uint64)
    limbs[:, -1] %= (f.modulus >> (32 * (f.L - 1)))
    edges = [0, 1, f.modulus - 1, f.R_mod]
    x = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)
    return torch.cat([x, f.from_ints(edges, dev, mont=False)])


# -- phases ----------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this check runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.library()
    say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f}s, "
        f"load {time.perf_counter() - t0:.1f}s")


def check_field(results: dict, gen, dev, n: int) -> None:
    err = 0
    for f in (fr_ops(), fq_ops()):
        a = random_elements(f, n, gen, dev)
        b = random_elements(f, n, gen, dev)[torch.randperm(n + 4, device=dev)]
        for kern, plain in ((f.mul, f.plain_mul), (f.add, f.plain_add),
                            (f.sub, f.plain_sub)):
            e = max_abs_err(kern(a, b), plain(a, b))
            e = max(e, max_abs_err(kern(a, b[:1]), plain(a, b[:1])))
            if e:
                raise AssertionError(f"K1 {kern.__name__} L={f.L}: err {e}")
            err = max(err, e)
    torch.cuda.synchronize()
    results["fr_ops"]["max_abs_err"] = err
    say(f"[K1] Fr and Fq mul/add/sub on {n} pairs + edges: bit-exact")


def check_ntt(results: dict, gen, dev, sizes) -> None:
    f = fr_ops()
    err = 0
    for log_n in sizes:
        eng = ntt_engine(log_n, dev)
        x = random_elements(f, eng.n - 4, gen, dev)
        fwd = eng.ntt(x)
        err = max(err, max_abs_err(fwd, eng.ntt_plain(x)))
        err = max(err, max_abs_err(eng.intt(x), eng.intt_plain(x)))
        err = max(err, max_abs_err(eng.intt(fwd), x))
        if err:
            raise AssertionError(f"K2 NTT 2^{log_n}: err {err}")
    torch.cuda.synchronize()
    results["ntt"]["max_abs_err"] = err
    say(f"[K2] NTT/iNTT at 2^{list(sizes)} vs plain, round trip: bit-exact")


def msm_inputs(points, scalars):
    c = M.window_bits(scalars.shape[0])
    mags, negs = M.signed_digits(scalars, c)
    idx, neg, offsets = M.bucket_runs(mags, negs, 1 << (c - 1))
    return c, (points[: scalars.shape[0]], idx, neg, offsets, mags.shape[0],
               1 << (c - 1))


def point_err(a, b) -> int:
    """Largest coordinate difference of two affine points, infinity taken
    as (0, 0) (not on the curve): 0 exactly when the points are equal."""
    ca = (0, 0) if a.inf else (int(a.x), int(a.y))
    cb = (0, 0) if b.inf else (int(b.x), int(b.y))
    return max(abs(ca[0] - cb[0]), abs(ca[1] - cb[1]))


def check_msm(results: dict, srs_packed: np.ndarray, dev) -> None:
    """K3's Jacobian window sums are compared as affine points: the kernel
    and the plain version reach them by different addition orders."""
    f = fr_ops()
    rnd = random.Random(7)
    points = M.points_from_packed(srs_packed, dev)
    n = min(1 << 10, srs_packed.shape[0])
    sc = [rnd.randrange(f.modulus) for _ in range(n)]
    sc[0] = 0
    c, args = msm_inputs(points, f.from_ints(sc, dev, mont=False))
    got = M.window_points(M.bucket_window_sums(*args))
    want = M.window_points(M.plain_bucket_window_sums(*args))
    err = max(point_err(a, b) for a, b in zip(got, want))
    err = max(err, point_err(M.horner(got, c), M.horner(want, c)))
    if err:
        raise AssertionError(f"K3 at {n} points disagrees with plain")
    n = srs_packed.shape[0]
    sc = [rnd.randrange(f.modulus) for _ in range(n)]
    scalars = f.from_ints(sc, dev, mont=False)
    t0 = time.perf_counter()
    got = M.msm(points, scalars)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = M.native_msm(srs_packed, scalars)
    t2 = time.perf_counter()
    err = max(err, point_err(got, want))
    if err:
        raise AssertionError(f"K3 at {n} points disagrees with native")
    results["msm"]["max_abs_err"] = err
    say(f"[K3] MSM 2^10 vs plain, 2^{n.bit_length() - 1} vs native Pippenger "
        f"(card {t1 - t0:.3f}s incl. host ladder, native {t2 - t1:.3f}s): "
        f"equal points")


def time_kernels(results: dict, srs_packed: np.ndarray, gen, dev) -> None:
    """Kernel and plain times at the main path's shapes. The outputs of the
    timed runs are compared too, so every shape timed is also checked."""
    f = fr_ops()
    a = random_elements(f, (1 << 20) - 4, gen, dev)
    b = random_elements(f, (1 << 20) - 4, gen, dev)
    k, got = timed(lambda: f.mul(a, b))
    p, want = timed(lambda: f.plain_mul(a, b))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K1 Fr mul 2^20: err {err}")
    fold_err(results["fr_ops"], err)
    results["fr_ops"].update(ms=k, plain_ms=p)
    say(f"[time] Fr mul 2^20: kernel {k:.3f} ms, plain {p:.3f} ms; equal")
    for log_n in (18, 19, 20):
        eng = ntt_engine(log_n, dev)
        x = random_elements(f, eng.n - 4, gen, dev)
        k, got = timed(lambda: eng.ntt(x))
        p, want = timed(lambda: eng.ntt_plain(x))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"K2 NTT 2^{log_n}: err {err}")
        fold_err(results["ntt"], err)
        say(f"[time] NTT 2^{log_n}: kernel {k:.3f} ms, plain {p:.3f} ms; "
            f"equal")
    results["ntt"].update(ms=k, plain_ms=p)
    base = M.points_from_packed(srs_packed, dev)
    for log_n in (19, 20):
        n = 1 << log_n
        # the 2^16 SRS powers repeated: repeats exercise the doubling branch
        points = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
        scalars = random_elements(f, n - 4, gen, dev)
        c, args = msm_inputs(points, scalars)
        k, got = timed(lambda: M.bucket_window_sums(*args))
        p, want = timed(lambda: M.plain_bucket_window_sums(*args), reps=1)
        err = max(point_err(u, v) for u, v in
                  zip(M.window_points(got), M.window_points(want)))
        if err:
            raise AssertionError(f"K3 at 2^{log_n} points disagrees with "
                                 f"plain")
        fold_err(results["msm"], err)
        total, _ = timed(lambda: M.msm(points, scalars))
        say(f"[time] MSM 2^{log_n} (c={c}): kernel {k:.3f} ms, plain "
            f"{p:.3f} ms (one run), whole msm() {total:.3f} ms; equal "
            f"window sums")
    results["msm"].update(ms=k, plain_ms=p)


def phase_main_path(results: dict, dev) -> None:
    kernels.reset_counts()
    t0 = time.perf_counter()
    pk, vk = api.synthesize_keys(16, device=dev)
    times = ", ".join(f"{k} {v:.1f}s" for k, v in pk.setup_times.items())
    say(f"[main] synthesize_keys(16): {time.perf_counter() - t0:.1f}s "
        f"({times}); n=2^{pk.marlin_pk.log_n}, "
        f"k=2^{max(vk.log_ks)}, SRS degree {vk.max_degree}")

    t0 = time.perf_counter()
    proof = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(1), zk=True)
    say(f"[main] cold prove (zk): {time.perf_counter() - t0:.1f}s")
    ct = api.compute_ciphertext(MESSAGE, KEY)
    t0 = time.perf_counter()
    if not api.verify_encryption(vk, proof, ct):
        raise AssertionError("the port's proof does not verify")
    say(f"[main] verify: True ({time.perf_counter() - t0:.1f}s)")
    bad = bytearray(ct)
    bad[0] ^= 1
    if api.verify_encryption(vk, proof, bytes(bad)):
        raise AssertionError("a flipped ciphertext bit still verifies")
    say("[main] flipped ciphertext bit: rejected")
    blob = api.serialize_proof(proof)
    back = api.deserialize_proof(blob)
    if api.serialize_proof(back) != blob or not api.verify_encryption(
            vk, back, ct):
        raise AssertionError("serialization round trip failed")
    say(f"[main] serialize round trip: {len(blob)} bytes, verifies")

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    warm = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(2), zk=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    stages = pk._prover.last_stage_times
    say(f"[main] warm prove (zk): {warm_s:.2f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()))
    warm_counts = {k: after[k] - before[k] for k in after}
    say(f"[main] launches in the warm prove: {warm_counts}; in the whole "
        f"main path: {after}")
    for name in after:
        if warm_counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the prove")
        results[name]["launches"] = after[name]
    if not api.verify_encryption(vk, warm, ct):
        raise AssertionError("the warm proof does not verify")
    say("[main] warm proof verifies")


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()

    results = {name: {"name": name, "route": "cuda",
                      "source": f"{PKG}/{src}", "replaces": rep}
               for name, (src, rep) in KERNEL_INFO.items()}
    gen = np.random.default_rng(0)
    check_field(results, gen, dev, 1 << 20)
    check_ntt(results, gen, dev, (10, 20))
    t0 = time.perf_counter()
    srs = generate_srs_native((1 << 16) - 1, random.Random(3))
    say(f"[K3] 2^16 test points from the native SRS generator: "
        f"{time.perf_counter() - t0:.1f}s")
    packed = srs.powers_g1.packed
    check_msm(results, packed, dev)
    time_kernels(results, packed, gen, dev)
    phase_main_path(results, dev)

    say(json.dumps({"kernels": [results[k] for k in KERNEL_INFO]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
