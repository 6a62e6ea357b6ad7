"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the Hopper kernels from `aes_zero_knowledge_proof_circuit_tpu_torch/
   csrc/` (one nvcc per source, all at once, then one link), with the build
   time;
3. kernels: K1 (field mul/add/sub), K2 (NTT stage), K3 (signed-window MSM
   buckets), K4 (8-bit bucket-scan MSM) and K5 (Fq digit-column product)
   against their plain PyTorch versions on the card, bit-exact, plus K3 and
   K4 against the native host Pippenger; kernel and plain times
   (synchronized, median of 3) at the main path's shapes, where the timed
   outputs of kernel and plain version are compared as well;
4. the ntt_mul path (K5's entry point) at 2^20 columns, with its launches
   and a sample of its columns checked against host integers;
5. main path: synthesize_keys(16) on the card (the index committed on K4),
   a zk proof of one AES-128 block, verification (and rejection of a
   flipped ciphertext bit), a proof serialization round trip, a warm prove
   on each MSM engine with its stage times (the K4 engine chosen by
   ZKAES_MSM_MXU=0, as a user chooses it), the K4 proof verified and its
   flipped bit rejected, zk=False proofs on both engines equal byte for
   byte; then, outside the counted run, the nine index commitments
   recomputed on K3.

Each path (ntt_mul, main) runs with the launch counts set to 0 just before
it and read just after; every kernel must have launched in the path that
uses it, and its `launches` entry is that count.

The run uses a cache directory of its own (templates, SRS, native library),
removed at the end, so the index is always computed. The second-to-last
line of stdout is the nvidia-smi line; before it a JSON line with one entry
per kernel. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
    to_msm_digits,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_ntt_mul as NM
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
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
    "msm_u8": ("csrc/msm_u8.cu",
               "aes_zero_knowledge_proof_circuit_tpu/ops/msm_pallas.py:146"),
    "fq_cols": ("csrc/fq_cols.cu",
                "aes_zero_knowledge_proof_circuit_tpu/ops/msm_ntt_mul.py:408"),
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


def k4_window_err(points, plan) -> int:
    """K4 against its plain version on one landing, per window as affine
    points (the two sum in different orders)."""
    got = M.window_points(MP.scan_window_sums(points, plan))
    want = M.window_points(MP.plain_scan_window_sums(points, plan))
    return max(point_err(a, b) for a, b in zip(got, want))


def check_msm_u8(results: dict, srs_packed: np.ndarray, dev) -> None:
    """K4's window sums at 2^10 points, and at edge shapes: n not a power
    of two, a long equal-digit run in the low window, windows 8-31 all
    zero, few points; then msm_device at 2^16 against the native
    Pippenger."""
    f = fr_ops()
    rnd = random.Random(11)
    points = M.points_from_packed(srs_packed, dev)
    err = 0
    for n, bound, lanes in ((1 << 10, f.modulus, None),
                            (1 << 10, f.modulus, 64), (1000, 1 << 64, None),
                            (3, f.modulus, None)):
        sc = [rnd.randrange(bound) for _ in range(n)]
        sc[0] = 0
        for i in range(1, min(n, 300)):
            sc[i] = (sc[i] & ~0xFF) | 0x5A
        d16 = MD.digit_limbs(f.from_ints(sc, dev, mont=False))
        e = k4_window_err(points[:n], MP.land(d16, lanes))
        if e:
            raise AssertionError(f"K4 at {n} points (lanes {lanes}) disagrees "
                                 f"with plain")
        err = max(err, e)
    n = srs_packed.shape[0]
    scalars = f.from_ints([rnd.randrange(f.modulus) for _ in range(n)], dev,
                          mont=False)
    t0 = time.perf_counter()
    got = MD.msm_device(points, MD.digit_limbs(scalars))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = M.native_msm(srs_packed, scalars)
    t2 = time.perf_counter()
    err = max(err, point_err(got, want))
    if err:
        raise AssertionError(f"K4 at {n} points disagrees with native")
    results["msm_u8"]["max_abs_err"] = err
    say(f"[K4] window sums at 2^10 (two lane counts), 1000 and 3 points vs "
        f"plain; msm_device 2^{n.bit_length() - 1} vs native Pippenger (card "
        f"{t1 - t0:.3f}s incl. landing and host ladder, native "
        f"{t2 - t1:.3f}s): equal points")


def fq_columns(n: int, gen) -> np.ndarray:
    """[64, n] digit columns in ntt_mul's input band: random values below
    2^376 in canonical digits, every fourth column with 63 added to its
    digits 0-45 (redundant digits up to 318), and edge columns 0, 1, q - 1
    and a value above q in band digits."""
    cols = np.zeros((NM.PAD_IN, n), np.int32)
    cols[:47] = gen.integers(0, 256, size=(47, n), dtype=np.int32)
    cols[:46, ::4] += 63
    edges = NM.ints_to_cols([0, 1, NM.Q_MOD - 1, 2**376], mont=False)
    q = NM.ints_to_cols([NM.Q_MOD - 1], mont=False)[:, 0]
    edges[:, 3] += q                       # 2^376 + q - 1, digits <= 510
    carry = edges[:, 3] >> 8
    edges[:, 3] = (edges[:, 3] & 255) + np.concatenate([[0], carry[:-1]])
    cols[:, :4] = edges
    return cols


def check_fq_cols(results: dict, gen, dev) -> None:
    """K5 against its plain version at 2^20 columns, timed, and on a sample
    of columns against host integers."""
    n = 1 << 20
    a = torch.from_numpy(fq_columns(n, gen)).to(dev)
    # columns permuted so that the edge columns meet random ones; made
    # contiguous, or the wrapper's copy of a strided input would be timed
    b = torch.from_numpy(np.ascontiguousarray(
        fq_columns(n, gen)[:, gen.permutation(n)])).to(dev)
    k, got = timed(lambda: NM.ntt_mul(a, b))
    p, want = timed(lambda: NM.plain_ntt_mul(a, b))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K5 at 2^20 columns: err {err}")
    check_fq_sample(a, b, got)
    results["fq_cols"].update(max_abs_err=err, ms=k, plain_ms=p)
    say(f"[K5] ntt_mul 2^20 columns: kernel {k:.3f} ms, plain {p:.3f} ms; "
        f"bit-exact (canonical digits), sampled columns equal host ints")


def check_fq_sample(a, b, out, m: int = 2048) -> None:
    """The first m columns (the edge columns among them) of out = a b R^-1
    against host integers."""
    va, vb, vo = (NM.cols_to_ints(t[:, :m]) for t in (a, b, out))
    if vo != [x * y % NM.Q_MOD for x, y in zip(va, vb)]:
        raise AssertionError("ntt_mul disagrees with host integers")
    if int(out.min()) < 0 or int(out.max()) > 255 or bool(out[48:].any()):
        raise AssertionError("ntt_mul output is not canonical digits")


def phase_ntt_mul(results: dict, gen, dev) -> None:
    """K5's own path: ntt_mul at 2^20 columns, counted."""
    a = torch.from_numpy(fq_columns(1 << 20, gen)).to(dev)
    b = torch.from_numpy(fq_columns(1 << 20, gen)).to(dev)
    kernels.reset_counts()
    out = NM.ntt_mul(a, b)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["fq_cols"] <= 0:
        raise AssertionError("K5 never launched in the ntt_mul path")
    check_fq_sample(a, b, out)
    results["fq_cols"]["launches"] = counts["fq_cols"]
    say(f"[ntt_mul] 2^20 columns: launches {counts}; sampled columns equal "
        f"host ints")


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
        total, k3_point = timed(lambda: M.msm(points, scalars))
        results["msm"].update(ms=k, plain_ms=p)
        say(f"[time] MSM 2^{log_n} (c={c}): kernel {k:.3f} ms, plain "
            f"{p:.3f} ms (one run), whole msm() {total:.3f} ms; equal "
            f"window sums")
        # K4 on the same points and scalars: the index and prover shapes
        d16 = MD.digit_limbs(scalars)
        t_land, plan = timed(lambda: MP.land(d16))
        k, got = timed(lambda: MP.scan_window_sums(points, plan))
        p, want = timed(lambda: MP.plain_scan_window_sums(points, plan),
                        reps=1)
        err = max(point_err(u, v) for u, v in
                  zip(M.window_points(got), M.window_points(want)))
        if err:
            raise AssertionError(f"K4 at 2^{log_n} points disagrees with "
                                 f"plain")
        fold_err(results["msm_u8"], err)
        total, k4_point = timed(lambda: MD.msm_device(points, d16))
        if point_err(k4_point, k3_point):
            raise AssertionError(f"msm_device at 2^{log_n} points disagrees "
                                 f"with msm")
        results["msm_u8"].update(ms=k, plain_ms=p)
        say(f"[time] 8-bit MSM 2^{log_n} ({plan.lanes} lanes of "
            f"{plan.steps}, {plan.n_tails} tails): kernel {k:.3f} ms, plain "
            f"{p:.3f} ms (one run), landing {t_land:.3f} ms, whole "
            f"msm_device() {total:.3f} ms; equal window sums, MSM equal to "
            f"K3's")


MAIN_PATH = ("fr_ops", "ntt", "msm", "msm_u8")


def require_launched(counts: dict, names, where: str) -> None:
    missing = [name for name in names if counts[name] <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched in {where}")


def warm_prove(pk, label: str):
    """One timed zk prove through api.encrypt; (proof, launches in it)."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    proof = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(2), zk=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    counts = {k: after[k] - before[k] for k in after}
    stages = pk._prover.last_stage_times
    say(f"[main] warm prove (zk, {label}): {warm_s:.2f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in stages.items()))
    say(f"[main] launches in it: {counts}")
    return proof, counts


def pallas_engine_key(pk):
    """A proving key whose prover commits on the K4 engine, chosen the way
    a user chooses it: ZKAES_MSM_MXU=0 when the prover is made."""
    pk4 = dataclasses.replace(pk, _prover=None, _witness=None)
    old = os.environ.get("ZKAES_MSM_MXU")
    os.environ["ZKAES_MSM_MXU"] = "0"
    try:
        t0 = time.perf_counter()
        proof = api.encrypt(MESSAGE, KEY, pk4, rng=random.Random(3), zk=True)
        say(f"[main] cold prove (zk, K4 engine): "
            f"{time.perf_counter() - t0:.1f}s")
    finally:
        if old is None:
            os.environ.pop("ZKAES_MSM_MXU")
        else:
            os.environ["ZKAES_MSM_MXU"] = old
    if pk4._prover.msm_engine != "pallas":
        raise AssertionError("ZKAES_MSM_MXU=0 did not select the K4 engine")
    return pk4, proof


def check_proof(vk, proof, ct: bytes, label: str) -> None:
    if not api.verify_encryption(vk, proof, ct):
        raise AssertionError(f"the {label} proof does not verify")
    bad = bytearray(ct)
    bad[0] ^= 1
    if api.verify_encryption(vk, proof, bytes(bad)):
        raise AssertionError(f"a flipped ciphertext bit still verifies "
                             f"({label})")
    say(f"[main] {label} proof verifies; flipped ciphertext bit rejected")


def phase_main_path(results: dict, dev) -> None:
    kernels.reset_counts()
    t0 = time.perf_counter()
    pk, vk = api.synthesize_keys(16, device=dev)
    index_counts = kernels.launch_counts()
    times = ", ".join(f"{k} {v:.1f}s" for k, v in pk.setup_times.items())
    say(f"[main] synthesize_keys(16): {time.perf_counter() - t0:.1f}s "
        f"({times}); n=2^{pk.marlin_pk.log_n}, "
        f"k=2^{max(vk.log_ks)}, SRS degree {vk.max_degree}; launches "
        f"{index_counts}")
    require_launched(index_counts, ("fr_ops", "ntt", "msm_u8"), "the index")

    t0 = time.perf_counter()
    proof = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(1), zk=True)
    say(f"[main] cold prove (zk): {time.perf_counter() - t0:.1f}s")
    ct = api.compute_ciphertext(MESSAGE, KEY)
    check_proof(vk, proof, ct, "cold")
    blob = api.serialize_proof(proof)
    back = api.deserialize_proof(blob)
    if api.serialize_proof(back) != blob or not api.verify_encryption(
            vk, back, ct):
        raise AssertionError("serialization round trip failed")
    say(f"[main] serialize round trip: {len(blob)} bytes, verifies")

    warm, counts = warm_prove(pk, "K3 engine")
    require_launched(counts, ("fr_ops", "ntt", "msm"), "the K3-engine prove")
    check_proof(vk, warm, ct, "warm K3-engine")

    pk4, _cold4 = pallas_engine_key(pk)
    warm4, counts = warm_prove(pk4, "K4 engine")
    require_launched(counts, ("fr_ops", "ntt", "msm_u8"),
                     "the K4-engine prove")
    if counts["msm"]:
        raise AssertionError("the K4-engine prove launched K3")
    check_proof(vk, warm4, ct, "warm K4-engine")

    plain3 = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(4), zk=False)
    plain4 = api.encrypt(MESSAGE, KEY, pk4, rng=random.Random(4), zk=False)
    blob3, blob4 = api.serialize_proof(plain3), api.serialize_proof(plain4)
    if blob3 != blob4 or not api.verify_encryption(vk, plain4, ct):
        raise AssertionError("the zk=False proofs of the two engines differ")
    say(f"[main] zk=False proofs on K3 and K4 engines: {len(blob3)} bytes, "
        f"equal byte for byte, verify")

    after = kernels.launch_counts()
    say(f"[main] launches in the whole main path: {after}")
    require_launched(after, MAIN_PATH, "the main path")
    for name in MAIN_PATH:
        results[name]["launches"] = after[name]

    # outside the counted run: the K4 index commitments recomputed on K3
    prover = pk._prover
    comms = iter(vk.index_comms)
    for m in prover.mat:
        for coeffs in (m["row_coeffs"], m["col_coeffs"], m["val_coeffs"]):
            got = M.msm(prover.srs_dev.slice(0, m["k"]),
                        to_msm_digits(coeffs))
            if point_err(got, next(comms).point):
                raise AssertionError("an index commitment made on K4 "
                                     "differs from K3's")
    say(f"[main] the {len(vk.index_comms)} index commitments (K4) equal "
        f"K3's")


def run(smi: str) -> None:
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
    check_msm_u8(results, packed, dev)
    check_fq_cols(results, gen, dev)
    time_kernels(results, packed, gen, dev)
    phase_ntt_mul(results, gen, dev)
    phase_main_path(results, dev)

    say(json.dumps({"kernels": [results[k] for k in KERNEL_INFO]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    smi = phase_device()
    cache = tempfile.mkdtemp(prefix="zkaes-smoke-")
    api.CONFIG.cache_dir = cache    # templates, SRS, keys, native library
    try:
        run(smi)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
