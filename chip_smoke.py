"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the Hopper kernels from `aes_zero_knowledge_proof_circuit_tpu_torch/
   csrc/` (one nvcc per source, all at once, then one link), with the build
   time and ptxas's registers and spills for every kernel;
3. kernels: K1 (field mul/add/sub, pow and inv, batch_inv), K2 (NTT
   passes), K3 (signed-window MSM: bucket accumulation, reduction and
   window ladder), K4 (8-bit bucket MSM: batch-affine tree levels, then the
   shared reduction), K5 (Fq digit-column product) and K6 (the fixed-base
   ladder of the SRS: K6 at 2^12 powers, the card's SRS of degree 2^16 - 1
   against the native one from the same seed; K6 timed at 2^20 and 2^22,
   its plain version at 2^20) against their plain
   PyTorch versions on the card, bit-exact (MSM points compared as affine
   points; batch_inv and inv at 2^20 rows with zero rows at the ends, at a
   chunk boundary and over a whole chunk; the NTT both ways at 2^1 ... 2^22
   across every pass boundary, three passes at 2^21 and 2^22; K4 with equal,
   opposite and infinity points in one bucket, printing the branches its
   levels took; K5 on band-edge
   columns), plus K3 and K4 against the native host Pippenger at 2^16;
   K4's Fq products and inversions on the timed inputs; kernel times and
   plain times at the main path's shapes, where the timed outputs of
   kernel and plain version are compared as well (the NTT at 2^18 ... 2^22;
   the MSMs at 2^19 and 2^20, and K3 and K4 alone at 2^21 and 2^22, where
   K4's MSM is held to K3's and the native checks below are the reference;
   the JSON line keeps the 16-byte main path's 2^20), each with the card's
   name and power limit and its bound (the larger of bytes over 3.35 TB/s
   and 32-bit multiply-adds over 132 SMs x 64 a clock x 1.98 GHz; K4's
   multiply-adds are its batch-affine Fq products on the timed inputs, with
   the former lane scan's count printed beside them). K1, K2
   and K5 are timed by CUDA events over 20 calls after a warm-up, queued
   behind a device sleep so that the events time the card and not the
   host's launches (K5 alone, as `ntt_mul` launches it after its checks,
   and `ntt_mul` whole as the wrapper's time); the MSMs, K4's landing and
   the plain versions by the median of 3 synchronized wall-clock runs;
4. the ntt_mul path (K5's entry point) at 2^20 columns, with its launches
   and a sample of its columns checked against host integers;
5. srs: the 1 KB ECB template (built on the host from the run's start in
   a process of its own) and its SRS of degree 2^26, generated once on the
   card (K1 and K6) and checkpointed with its 2^22 prefix, so that every
   smaller key truncates it; three of its powers checked by the host
   pairing e(P_i, h) = e(P_{i-1}, tau h);
6. main path: synthesize_keys(16) on the card (the index committed on K4),
   a zk proof of one AES-128 block, verification (and rejection of a
   flipped ciphertext bit), a proof serialization round trip, a warm prove
   on each MSM engine with its stage times (the K4 engine chosen by
   ZKAES_MSM_MXU=0, as a user chooses it), the K4 proof verified and its
   flipped bit rejected, zk=False proofs on both engines equal byte for
   byte; then, outside the counted run, the nine index commitments
   recomputed on K3, and K3 and K4 at the key's 2^20 + 1 SRS points
   against the native Pippenger;
7. entry: the flagship forward step (`entry.py`, the counterpart of
   `__graft_entry__.entry()`) on the card over the cached 16-byte
   template: for the FIPS-197 vector, all-zero, all-one and a seeded pair,
   the ciphertext bits equal the AES oracle's and the R1CS residual is 0;
   a flipped witness bit (round 1, the key schedule, the ciphertext) makes
   the residual non-zero; the warm forward's milliseconds;
8. cbc: synthesize_keys(16, mode="cbc"), a cold and a warm zk proof with
   its iv, verification, rejection of a flipped ciphertext bit and of a
   flipped iv bit, a serialization round trip;
9. batch: encrypt_batch of four messages on the main path's key under a
   seeded rng, two proofs in flight on two CUDA streams: the depth the
   memory rule picks (two) and a warm prove's device bytes against the
   reckoning the rule counts on; the batch timed, then the same four
   proofs made in turn by encrypt(m_i) from Random(seed i) (the seeds
   drawn as the JAX package draws them), each equal byte for byte, their
   times and sum, then the batch again; the batch's launches exactly four
   times one prove's, and its peak device memory (two proofs in flight);
   each proof verifies against its own ciphertext and not the next
   message's. The same again on the 64-byte key after 64B (batch64);
10. 32B: synthesize_keys(32, mode="cbc") (n = 2^19, the index committed on
   K4 over up to 2^21 points), a cold and a warm zk proof with stage times,
   verification, rejection of a flipped bit in the second ciphertext block;
   then K3 and K4 at the key's 2^21 + 1 SRS points against the native
   Pippenger;
11. 64B: synthesize_keys(64) (four ECB blocks: n = 2^20, the index
   committed on K4 over up to 2^21 points, round-3 cosets and SRS of 2^22),
   a cold and a warm zk proof on the K3 engine and a warm one on the K4
   engine with stage times, zk=False proofs on both engines equal byte for
   byte, verification, rejection of a flipped bit in the fourth ciphertext
   block, a serialization round trip, the card's peak memory in the
   proves; then K3 and K4 at the key's 2^22 + 1 SRS points against the
   native Pippenger;
12. mesh: a mesh of 4 shards on cuda:(i mod the card count) (all four on
   one card, or one a card on four), with the cards' peer access: batched
   K2 (the four-step NTT's rows) against its batched plain version at the
   shard shapes of 2^20, 2^22 and 2^26, and timed at 2^26's; ntt_sharded
   against the single-device NTT at 2^20, 2^22 and 2^26 both ways;
   msm_sharded against the one-device MSM (K3 at the 64-byte key's 2^22 +
   1 SRS points, K4 at 2^20); encrypt(mesh=) on the 16- and 64-byte keys
   (K3) and on the 16-byte key's K4 engine, a cold and a warm proof each,
   with stages, launches and each card's peak memory, each proof equal
   byte for byte to the single-device proof from its seed, verified and a
   flipped bit rejected; encrypt_batch(mesh=) of four 16-byte messages
   (the fill on the mesh, the proofs on the key's own prover: no mesh
   prover is made), each proof equal to encrypt's from its seed and
   verified; then parallel.dryrun.dryrun_multichip(4);
13. 1KB: synthesize_keys(1024) (64 ECB blocks: n = 2^24, matrices of
   2^24, 2^24 and 2^25, the index committed on K4 in window groups,
   round-2 and round-3 cosets and SRS of 2^26), a cold and a warm zk
   proof on the K3 engine and a warm one on the K4 engine with stage times
   and launches, verification on the host, rejection of a flipped bit in
   the 64th ciphertext block, a serialization round trip, the card's
   memory before and over the proves, the warm prove's bytes against the
   reckoning and encrypt_batch's depth for this key (one: a second 1 KB
   proof does not fit on an 80 GB card); then K3 and K4 at 2^25 + 1 SRS
   points equal to each other, and K3 at the key's 2^26 + 1 points equal
   to the sum of K3 over its two halves;
14. plonk: the AES-128 Plonk circuit (272,544 gates, n = 2^19), the host
   setup on the SRS checkpoint truncated to degree n + 8, a cold and a warm
   zk proof on the card (TorchPlonkProver: the 2^21 coset transforms on K2,
   every commitment on K3) with stage times, verified on the host, and
   rejected against a flipped ciphertext bit; then a chain circuit of 2^12
   gates whose proof on the card equals the host prover's field for field.

Each path (ntt_mul, srs, main; and each index and prove of cbc, batch, 32B,
64B, batch64, mesh, 1KB and plonk) runs with the launch counts set to 0 just before
it and read just after; every kernel must have launched in the path that
uses it (K1, K2 and K3 in each prove, K1, K2 and K4 in each index, K1 and
K6 in the SRS generation), and the JSON `launches` entry is the main
path's count (K5's from the ntt_mul path, K6's from the srs path);
`mesh_launches` is the count over the mesh phase's proves and batch. The
entry path's forward step is torch work alone (the witness fill and
`index_add_`): its counts are printed and must be 0.

The run sets PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True unless it is
set already, and uses a cache directory of its own (templates, SRS, keys,
native library: about 20 GB at 1 KB), removed at the end, so the index is
always computed. The second-to-last
line of stdout is the nvidia-smi line; before it a JSON line with one entry
per kernel. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the allocator maps growing segments instead of reserving a block a size
# (41 GiB reserved for a 16.7 GiB peak at 64 bytes without it); it is read
# when torch first touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aes_zero_knowledge_proof_circuit_tpu_torch import api, kernels
from aes_zero_knowledge_proof_circuit_tpu_torch import entry as E
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover import (
    proof_bytes,
    to_msm_digits,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import edge_inputs as EI
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import fixed_base as FB
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm as M
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_device as MD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_ntt_mul as NM
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import msm_pallas as MP
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import (
    INV_CHUNK,
    fq_ops,
    fr_ops,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import pairing_host as PH
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import poly as P
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.aes_host import encrypt_ecb
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.curve_host import (
    g1_generator,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import ntt_engine
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel import (
    sharded_ntt as SN,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import (
    make_mesh,
    replicated,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.sharded_msm import (
    msm_sharded,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import backend as plonk
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.aes_map import (
    AesPlonkCircuit,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.circuit import (
    PlonkCircuit,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
    TorchPlonkProver,
    field_rows,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import srs as S
from aes_zero_knowledge_proof_circuit_tpu_torch.utils.srs import (
    generate_srs_native,
)

PKG = "aes_zero_knowledge_proof_circuit_tpu_torch"
KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
MESSAGE = bytes(range(16))
IV = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
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
    "srs": ("csrc/srs.cu",
            "aes_zero_knowledge_proof_circuit_tpu/parallel/srs_gen.py:108"),
}
KB_BYTES = 1024    # the largest message of the run: its SRS is generated first


# the card's peaks the bounds are taken against (NVIDIA H100 SXM at 700 W):
# HBM bytes a second, and 32-bit multiply-adds a second (CUDA C++
# Programming Guide, arithmetic instructions, compute capability 9.0: 64 a
# clock an SM; 132 SMs at the 1.98 GHz boost clock)
HBM_BYTES_S = 3.35e12
MAIN_LOG = 20      # the 16-byte main path's NTT and MSM size, in the JSON line
PLAIN_MSM_LOGS = (19, 20)   # MSM sizes whose plain versions are timed too
IMAD_S = 132 * 64 * 1.98e9
# 32-bit multiply-adds of one Montgomery product: 2 (low and high halves)
# for each of the L^2 limb products of a * b and of m * p
FR_PRODUCT = 2 * 2 * 8 * 8
FQ_PRODUCT = 2 * 2 * 12 * 12
CARD = ""          # nvidia-smi's "name, power limit", set by phase_device


def say(*args) -> None:
    print(*args, flush=True)


def set_bound(entry: dict, nbytes: float, imads: float) -> None:
    """bound_ms and bound_by of one kernel from this run's bytes and
    multiply-adds."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = imads / IMAD_S * 1e3
    entry.update(bound_ms=max(by_bytes, by_ops),
                 bound_by="bytes" if by_bytes >= by_ops else "operations")


def events_ms(fn, reps: int = 20):
    """(CUDA-event milliseconds a call over `reps` calls after a warm-up,
    the last result). The calls are queued behind a device sleep longer
    than their launches take on the host, so the events time the card."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # ~10 ms at the boost clock
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


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
    global CARD
    CARD = smi
    say(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.library()
    say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f}s, "
        f"load {time.perf_counter() - t0:.1f}s [{CARD}]")
    for src, name, regs, st, ld in kernels.resource_usage():
        say(f"[ptxas] {src} {name}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")


def with_zero_rows(x: torch.Tensor) -> torch.Tensor:
    """x with zero rows at the first and last row, on each side of a
    batch_inv chunk boundary and over a whole chunk."""
    x = x.clone()
    c = INV_CHUNK
    for i in (0, c - 1, c, x.shape[0] - 1):
        x[i] = 0
    x[5 * c:6 * c] = 0
    return x


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
        z = with_zero_rows(a)
        for name, got, want in (
                ("batch_inv", f.batch_inv(z), f.plain_batch_inv(z)),
                ("inv", f.inv(z), f.plain_pow(z, f.modulus - 2)),
                ("batch_inv 1 row", f.batch_inv(z[1:2]),
                 f.plain_batch_inv(z[1:2]))):
            e = max_abs_err(got, want)
            if e:
                raise AssertionError(f"K1 {name} L={f.L}: err {e}")
            err = max(err, e)
    torch.cuda.synchronize()
    results["fr_ops"]["max_abs_err"] = err
    say(f"[K1] Fr and Fq mul/add/sub, batch_inv and inv on {n} rows + edges "
        f"(zero rows at both ends, a chunk boundary and a whole chunk): "
        f"bit-exact")


def check_ntt(results: dict, gen, dev, sizes) -> None:
    f = fr_ops()
    err = 0
    for log_n in sizes:
        eng = ntt_engine(log_n, dev)
        x = random_elements(f, max(eng.n - 4, 0), gen, dev)[:eng.n]
        fwd = eng.ntt(x)
        err = max(err, max_abs_err(fwd, eng.ntt_plain(x)))
        err = max(err, max_abs_err(eng.intt(x), eng.intt_plain(x)))
        err = max(err, max_abs_err(eng.intt(fwd), x))
        if err:
            raise AssertionError(f"K2 NTT 2^{log_n}: err {err}")
    torch.cuda.synchronize()
    results["ntt"]["max_abs_err"] = err
    say(f"[K2] NTT/iNTT at 2^{list(sizes)} (passes of "
        f"{[ntt_engine(k, dev).widths for k in sizes]} stages) vs plain, "
        f"round trip: bit-exact")


def msm_inputs(points, scalars, c=None):
    """bucket_msm's arguments for the first len(scalars) points, at window
    width c (window_bits(n) by default)."""
    c = c or M.window_bits(scalars.shape[0])
    mags, negs = M.signed_digits(scalars, c)
    idx, neg, offsets = M.bucket_runs(mags, negs, 1 << (c - 1))
    return (points[: scalars.shape[0]], idx, neg, offsets, mags.shape[0],
            1 << (c - 1), c)


def point_err(a, b) -> int:
    """Largest coordinate difference of two affine points, infinity taken
    as (0, 0) (not on the curve): 0 exactly when the points are equal."""
    ca = (0, 0) if a.inf else (int(a.x), int(a.y))
    cb = (0, 0) if b.inf else (int(b.x), int(b.y))
    return max(abs(ca[0] - cb[0]), abs(ca[1] - cb[1]))


def xyzz_err(got, want) -> int:
    """point_err over (MSM point, window sums) pairs of XYZZ tensors,
    compared as affine points (kernel and plain version reach them by
    different addition orders)."""
    return max(point_err(u, v) for g, w in zip(got, want)
               for u, v in zip(M.xyzz_to_affine(g), M.xyzz_to_affine(w)))


def k3_imads(args) -> float:
    """32-bit multiply-adds K3 needs on these inputs: a mixed add (10 Fq
    products) for every sorted pair of a nonzero digit but the first of
    its bucket, two full adds (14 products each) a bucket for the running
    sums, and the ladder's c (W - 1) doublings (9 products) and W adds."""
    offsets, windows, buckets, c = args[3], args[4], args[5], args[6]
    counts = (offsets[1:] - offsets[:-1]).view(windows, buckets + 1)[:, 1:]
    adds = int(counts.sum()) - int((counts > 0).sum())
    products = (10 * adds + 2 * 14 * windows * buckets
                + 9 * c * (windows - 1) + 14 * windows)
    return products * FQ_PRODUCT


OLD_STEPS = 64     # sorted pairs a thread of K4's former lane scan


def lane_scan_imads(d16) -> float:
    """32-bit multiply-adds K4's former lane scan needed on these inputs:
    the bound of K4's rows before its batch-affine design, printed beside
    the present bound so that the rows still compare. On the lane scan's
    geometry (lanes of OLD_STEPS sorted pairs), a mixed add (10 Fq
    products) for every pair of a nonzero digit but the first of its (lane,
    bucket) run, a full add to merge each further run of a bucket, two a
    bucket for the running sums, and the ladder's 8 x 31 doublings and 32
    adds."""
    n = d16.shape[0]
    lanes = -(-n // OLD_STEPS)
    steps = -(-n // lanes)
    ds = torch.sort(MP.window_digits(d16), dim=1).values
    ds = torch.cat([torch.zeros((MP.WINDOWS, lanes * steps - n),
                                dtype=ds.dtype, device=ds.device), ds], 1)
    ds = ds.view(MP.WINDOWS, lanes, steps)
    last = torch.ones_like(ds, dtype=torch.bool)
    last[..., :-1] = ds[..., 1:] != ds[..., :-1]
    runs = int((last & (ds > 0)).sum())
    pairs = int((ds > 0).sum())
    win = torch.arange(MP.WINDOWS, device=ds.device).view(MP.WINDOWS, 1, 1)
    counts = torch.bincount((win * MP.BUCKETS + ds).reshape(-1),
                            minlength=MP.WINDOWS * MP.BUCKETS)
    nonempty = int((counts.view(MP.WINDOWS, MP.BUCKETS)[:, 1:] > 0).sum())
    products = (10 * (pairs - runs) + 14 * (runs - nonempty)
                + 2 * 14 * MP.WINDOWS * MP.BUCKETS + 9 * 8 * 31 + 14 * 32)
    return products * FQ_PRODUCT


def k4_products(plan, kinds: dict):
    """(Fq products, field inversions) of the batch-affine K4 on these
    inputs; the products set K4's bound. 6 an affine add and 7 a doubling
    (the plain version's count of the levels' items), each level's block
    trees (B - 1 products up, 2 (B - 1) down and the Montgomery correction
    of the one inversion, a block of B = LEVEL_BLOCK threads), 14 a join of
    the XYZZ merge, the reduction's running sums, the 16 window pairs (8
    doublings of 9 products and an add of 14 each) and the ladder over them
    (15 x 16 doublings, 16 adds)."""
    blocks = int(plan.geometry[:, 2].sum()) // MP.LEVEL_BLOCK
    tree = 3 * (MP.LEVEL_BLOCK - 1) + 1
    last = plan.first[plan.levels]
    left = last[1:] - last[:-1]
    joins = int((left - 1).clamp(min=0).sum())
    pairs = MP.WINDOWS // 2
    products = (6 * kinds.get("add", 0) + 7 * kinds.get("dbl", 0)
                + tree * blocks + 14 * joins
                + 2 * 14 * MP.WINDOWS * MP.BUCKETS + pairs * (9 * 8 + 14)
                + 9 * 16 * (pairs - 1) + 14 * pairs)
    return products, blocks


def landing_kinds(plan) -> dict:
    """K4's level items counted from the landing alone, where the plain
    version does not run: at each affine level a bucket's inputs join in
    pairs and an odd last one is copied. A pair is counted as an add (6
    products), so a doubling (7) is undercounted and the bound stays a
    least time; the SRS points hold no infinity and no negated pair, so no
    pair cancels. At the plain version's sizes the pairs must equal its
    adds, doublings and cancellations."""
    kinds = {"add": 0, "copy": 0}
    for lvl in range(plan.levels):
        m = plan.first[lvl][1:] - plan.first[lvl][:-1]
        kinds["add"] += int((m // 2).sum())
        kinds["copy"] += int((m % 2).sum())
    return kinds


def kinds_text(kinds: dict) -> str:
    return ", ".join(f"{k} {kinds.get(k, 0)}" for k in MP.KINDS)


def msm_bytes(n: int) -> float:
    """Bytes an n-term MSM must move: each affine point (96 B) and scalar
    (32 B) read once; the one output point is negligible."""
    return n * (96 + 32)


K3_GROUP = 3       # windows a group of K3 at 2^26 points (1 KB proofs)
K4_GROUP = 4       # windows a group of K4 at 2^25 points (the 1 KB index)


def grouped_k3(fn, pts, scalars, c=None):
    """fn (bucket_msm or its plain version) over the windows of
    msm_inputs(pts, scalars, c) in groups of K3_GROUP, as msm_point runs a
    1 KB commit: each group's sums into its rows of one wsums, the ladder
    in the last group only. (MSM point, wsums), XYZZ."""
    c = c or M.window_bits(scalars.shape[0])
    mags, negs = M.signed_digits(scalars, c)
    w_count, buckets = mags.shape[0], 1 << (c - 1)
    wsums = torch.empty((w_count, 4, 12), dtype=torch.int32,
                        device=pts.device)
    for w0 in range(0, w_count, K3_GROUP):
        w1 = min(w_count, w0 + K3_GROUP)
        runs = M.bucket_runs(mags[w0:w1], negs[w0:w1], buckets)
        out, _ = fn(pts[: scalars.shape[0]], *runs, w1 - w0, buckets, c,
                    wsums, w0, ladder=w1 == w_count)
    return out, wsums


def grouped_k4(fn, pts, digits, lanes, **kw):
    """fn (scan_msm or its plain version) over the 32 windows landed in
    groups of K4_GROUP, as msm_parts runs the 1 KB index: (MSM point,
    wsums), XYZZ."""
    wsums = torch.empty((MP.WINDOWS, 4, 12), dtype=torch.int32,
                        device=pts.device)
    for w0 in range(0, MP.WINDOWS, K4_GROUP):
        w1 = min(MP.WINDOWS, w0 + K4_GROUP)
        out, _ = fn(pts, MP.land(digits, lanes, w0, w1), wsums=wsums,
                    ladder=w1 == MP.WINDOWS, **kw)
    return out, wsums


def check_msm(results: dict, srs_packed: np.ndarray, dev) -> None:
    """K3 (point and window sums) against its plain version at 2^10 points
    (its own window width and the full 13-bit geometry, with repeated,
    negated and zero pairs) and at 3 points, each also in groups of
    K3_GROUP windows (grouped kernel against grouped plain, and equal to
    the one-group MSM); then msm() at 2^16 against the native Pippenger."""
    f = fr_ops()
    rnd = random.Random(7)
    points = M.points_from_packed(srs_packed, dev)
    err = 0
    for n, c in ((1 << 10, None), (1 << 10, 13), (3, None)):
        pts = points[:n].clone()
        sc = [rnd.randrange(f.modulus) for _ in range(n)]
        sc[0] = 0
        if n > 4:
            pts[1], sc[1] = pts[4], sc[4]      # P + P in every window
            pts[2], sc[2] = pts[3], f.modulus - sc[3]   # P - P
        scalars = f.from_ints(sc, dev, mont=False)
        args = msm_inputs(pts, scalars, c)
        one = M.bucket_msm(*args)
        e = xyzz_err(one, M.plain_bucket_msm(*args))
        grouped = grouped_k3(M.bucket_msm, pts, scalars, c)
        e_grouped = max(xyzz_err(grouped, grouped_k3(M.plain_bucket_msm, pts,
                                                     scalars, c)),
                        xyzz_err(grouped, one))
        if e or e_grouped:
            raise AssertionError(f"K3 at {n} points (c={args[-1]}) disagrees "
                                 f"with plain (one group: {e}, groups of "
                                 f"{K3_GROUP}: {e_grouped})")
        err = max(err, e, e_grouped)
    n = srs_packed.shape[0]
    sc = [rnd.randrange(f.modulus) for _ in range(n)]
    scalars = f.from_ints(sc, dev, mont=False)
    t0 = time.perf_counter()
    got = M.msm(points, scalars)
    t1 = time.perf_counter()
    want = M.native_msm(srs_packed, scalars)
    t2 = time.perf_counter()
    err = max(err, point_err(got, want))
    if err:
        raise AssertionError(f"K3 at {n} points disagrees with native")
    results["msm"]["max_abs_err"] = err
    say(f"[K3] MSM at 2^10 (c=7 and 13) and 3 points vs plain, one group "
        f"and groups of {K3_GROUP} windows (ladder in the last); msm() at "
        f"2^{n.bit_length() - 1} vs native Pippenger (card {t1 - t0:.3f}s "
        f"with digits, sort and affine result; native {t2 - t1:.3f}s): "
        f"equal points [{CARD}]")


def check_msm_u8(results: dict, srs_packed: np.ndarray, dev) -> None:
    """K4 (point and window sums) against its plain version at 2^10 points
    (the default chunk geometry, one add a thread, and lanes = 64, about 250
    adds a thread over every tree level) with equal, opposite and infinity
    points in one bucket, and at edge shapes: n not a power of two, a long
    equal-digit run in the low window, windows 8-31 all zero, few points;
    each also in groups of K4_GROUP windows (grouped kernel against grouped
    plain, and equal to the one-group MSM); then msm_device at 2^16 against
    the native Pippenger."""
    f = fr_ops()
    rnd = random.Random(11)
    points = M.points_from_packed(srs_packed, dev)
    err = 0
    kinds = {}
    for n, bound, lanes in ((1 << 10, f.modulus, None),
                            (1 << 10, f.modulus, 64), (1000, 1 << 64, None),
                            (3, f.modulus, None)):
        sc = [rnd.randrange(bound) for _ in range(n)]
        sc[0] = 0
        for i in range(1, min(n, 300)):
            sc[i] = (sc[i] & ~0xFF) | 0x5A
        pts = EI.k4_edge_points(points, n)
        digits = MD.digit_limbs(f.from_ints(sc, dev, mont=False))
        plan = MP.land(digits, lanes)
        one = MP.scan_msm(pts, plan)
        e = xyzz_err(one, MP.plain_scan_msm(pts, plan, kinds))
        grouped = grouped_k4(MP.scan_msm, pts, digits, lanes)
        e_grouped = max(xyzz_err(grouped, grouped_k4(MP.plain_scan_msm, pts,
                                                     digits, lanes)),
                        xyzz_err(grouped, one))
        if e or e_grouped:
            raise AssertionError(f"K4 at {n} points (lanes {lanes}) disagrees "
                                 f"with plain (one group: {e}, groups of "
                                 f"{K4_GROUP}: {e_grouped})")
        err = max(err, e, e_grouped)
        say(f"[K4] {n} points, lanes {plan.lanes}: {plan.levels} affine "
            f"levels (chunks {plan.geometry[:, 1].tolist()}), "
            f"{plan.merge_passes} XYZZ merge levels; equal to plain, one "
            f"group and groups of {K4_GROUP} windows")
    if not all(kinds.get(k, 0) for k in MP.KINDS):
        raise AssertionError(f"K4's inputs missed a branch: {kinds}")
    n = srs_packed.shape[0]
    scalars = f.from_ints([rnd.randrange(f.modulus) for _ in range(n)], dev,
                          mont=False)
    t0 = time.perf_counter()
    got = MD.msm_device(points, MD.digit_limbs(scalars))
    t1 = time.perf_counter()
    want = M.native_msm(srs_packed, scalars)
    t2 = time.perf_counter()
    err = max(err, point_err(got, want))
    if err:
        raise AssertionError(f"K4 at {n} points disagrees with native")
    results["msm_u8"]["max_abs_err"] = err
    say(f"[K4] MSM at 2^10 (two chunk geometries), 1000 and 3 points vs "
        f"plain, level items reached: {kinds_text(kinds)}; msm_device "
        f"2^{n.bit_length() - 1} vs native Pippenger (card {t1 - t0:.3f}s "
        f"with landing and affine result, native {t2 - t1:.3f}s): equal "
        f"points [{CARD}]")


def check_fq_cols(results: dict, gen, dev) -> None:
    """K5 against its plain version at 2^20 columns, timed, and on a sample
    of columns against host integers."""
    n = 1 << 20
    a = torch.from_numpy(EI.fq_columns(n, gen)).to(dev)
    # columns permuted so that the edge columns meet random ones; made
    # contiguous, or the wrapper's copy of a strided input would be timed
    b = torch.from_numpy(np.ascontiguousarray(
        EI.fq_columns(n, gen)[:, gen.permutation(n)])).to(dev)
    out = torch.empty_like(a)
    k, _ = events_ms(lambda: NM._launch(a, b, out))
    w, got = events_ms(lambda: NM.ntt_mul(a, b))
    if not torch.equal(out, got):
        raise AssertionError("K5 alone and ntt_mul disagree")
    p, want = timed(lambda: NM.plain_ntt_mul(a, b))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K5 at 2^20 columns: err {err}")
    check_fq_sample(a, b, got)
    results["fq_cols"].update(max_abs_err=err, ms=k, plain_ms=p)
    # 51 digit rows of each input read, 64 rows written; a column's
    # multiply-adds: one Fq product and 36 word products (each operand's
    # reduction by k q, 12 words each, and the 2^-16 step's m q)
    set_bound(results["fq_cols"], (2 * 51 + NM.PAD_IN) * 4 * n,
              (FQ_PRODUCT + 2 * 36) * n)
    say(f"[K5] ntt_mul 2^20 columns: kernel {k:.4f} ms (events, the kernel "
        f"alone), wrapper ms {w:.4f} (ntt_mul with its checks), plain "
        f"{p:.3f} ms, "
        f"bound {results['fq_cols']['bound_ms']:.4f} ms "
        f"({results['fq_cols']['bound_by']}); bit-exact "
        f"(canonical digits), sampled columns equal host ints [{CARD}]")


def check_fq_sample(a, b, out, m: int = 2048) -> None:
    """The first m columns (the edge columns among them) of out = a b R^-1
    against host integers."""
    va, vb, vo = (NM.cols_to_ints(t[:, :m]) for t in (a, b, out))
    if vo != [x * y % NM.Q_MOD for x, y in zip(va, vb)]:
        raise AssertionError("ntt_mul disagrees with host integers")
    if int(out.min()) < 0 or int(out.max()) > 255 or bool(out[48:].any()):
        raise AssertionError("ntt_mul output is not canonical digits")


def fixed_base_products(scalars: torch.Tensor) -> int:
    """Fq products K6 needs on these scalars: a mixed add (10 products) for
    every nonzero byte of a scalar but its first."""
    nonzero = (FB.scalar_bytes(scalars) != 0).sum(dim=0)
    return 10 * int((nonzero - 1).clamp(min=0).sum())


def check_fixed_base(results: dict, srs_native, dev) -> None:
    """K6 against its plain version at 2^12 powers of a random tau (both
    normalized by the same batch inversion: bit-exact limbs), the card's SRS
    against the native one of degree 2^16 - 1 from the same seed; then K6
    by events at 2^20 and 2^22 (one chunk of the device SRS, S.SRS_CHUNK)
    with its bound, and its outputs against the plain version's (one run
    at 2^20, timed; at 2^22 over slices of 2^20 powers, so that the plain
    version's temporaries stay those of 2^20)."""
    f = fr_ops()
    tau = random.Random(19).randrange(1, R_MOD)
    table = FB.window_table(g1_generator(), dev)

    def powers(log_n: int) -> torch.Tensor:
        return f.to_canonical_limbs(P.powers(P.scalar(tau, dev), 1 << log_n))

    sc = powers(12)
    err = max_abs_err(FB.to_packed(FB.fixed_base(table, sc)),
                      FB.to_packed(FB.plain_fixed_base(table, sc)))
    if err:
        raise AssertionError(f"K6 at 2^12 powers: err {err}")
    t0 = time.perf_counter()
    got = S.generate_srs_device(srs_native.max_degree, random.Random(3), dev)
    secs = time.perf_counter() - t0
    if not np.array_equal(got.powers_g1.packed, srs_native.powers_g1.packed) \
            or got.gamma_powers_g1 != srs_native.gamma_powers_g1 \
            or (got.h, got.tau_h) != (srs_native.h, srs_native.tau_h):
        raise AssertionError("the card's SRS differs from the native one")
    say(f"[K6] 2^12 powers vs plain: bit-exact; the card's SRS of degree "
        f"{srs_native.max_degree} ({secs:.2f}s) equals the native one from "
        f"the same seed [{CARD}]")
    for log_n in (20, 22):
        n = 1 << log_n
        sc = powers(log_n)
        k, out = events_ms(lambda: FB.fixed_base(table, sc))
        products = fixed_base_products(sc)
        bound = {}
        # each scalar (32 B) read and each XYZZ point (192 B) written once,
        # the 786 KB table read once
        set_bound(bound, n * (32 + 192) + table.numel() * 4,
                  products * FQ_PRODUCT)
        step = 1 << MAIN_LOG
        p, want = timed(lambda: torch.cat([
            FB.plain_fixed_base(table, sc[a:a + step])
            for a in range(0, n, step)]), reps=1)
        err = max_abs_err(FB.to_packed(out), FB.to_packed(want))
        if err:
            raise AssertionError(f"K6 at 2^{log_n} powers: err {err}")
        plain_text = f"{p:.3f} ms (one run), equal"
        if log_n == MAIN_LOG:
            results["srs"].update(max_abs_err=err, ms=k, plain_ms=p, **bound)
        else:
            plain_text += f" (slices of 2^{MAIN_LOG})"
            results["srs"]["max_abs_err"] = max(
                err, results["srs"]["max_abs_err"])
        say(f"[time] K6 fixed-base ladder 2^{log_n} powers: kernel {k:.3f} "
            f"ms (events), bound {bound['bound_ms']:.3f} ms "
            f"({bound['bound_by']}; {products} Fq products, "
            f"{products / n / 10:.2f} mixed adds a power), plain "
            f"{plain_text} [{CARD}]")


def phase_ntt_mul(results: dict, gen, dev) -> None:
    """K5's own path: ntt_mul at 2^20 columns, counted."""
    a = torch.from_numpy(EI.fq_columns(1 << 20, gen)).to(dev)
    b = torch.from_numpy(EI.fq_columns(1 << 20, gen)).to(dev)
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


def time_batch_inv(f, a: torch.Tensor, n: int) -> None:
    """K1's batch_inv at n rows: events time, launches a call, bound (the
    larger of its bytes, each row read and written once, and 3n products
    plus the one Fermat chain's at the card's multiply-add rate)."""
    kernels.reset_counts()
    f.batch_inv(a)
    launches = kernels.launch_counts()["fr_ops"]
    k, got = events_ms(lambda: f.batch_inv(a))
    p, want = timed(lambda: f.plain_batch_inv(a))
    if max_abs_err(got, want):
        raise AssertionError("K1 batch_inv 2^20 disagrees with plain")
    e = f.modulus - 2
    chain = e.bit_length() - 1 + bin(e).count("1") - 1
    bound = {}
    set_bound(bound, 2 * n * 32, (3 * n + chain) * FR_PRODUCT)
    say(f"[time] Fr batch_inv 2^20: kernel {k:.4f} ms (events), "
        f"{launches} launches a call, plain {p:.3f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; the Fermat chain "
        f"{chain} products in one thread); equal [{CARD}]")


def time_kernels(results: dict, srs_packed: np.ndarray, gen, dev) -> None:
    """Kernel and plain times at the main path's shapes, with each
    kernel's bound. The outputs of the timed runs are compared too, so
    every shape timed is also checked."""
    f = fr_ops()
    n = 1 << 20
    a = random_elements(f, n - 4, gen, dev)
    b = random_elements(f, n - 4, gen, dev)
    k, got = events_ms(lambda: f.mul(a, b))
    p, want = timed(lambda: f.plain_mul(a, b))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K1 Fr mul 2^20: err {err}")
    fold_err(results["fr_ops"], err)
    results["fr_ops"].update(ms=k, plain_ms=p)
    set_bound(results["fr_ops"], 3 * n * 32, n * FR_PRODUCT)
    say(f"[time] Fr mul 2^20: kernel {k:.4f} ms (events), plain {p:.3f} ms, "
        f"bound {results['fr_ops']['bound_ms']:.4f} ms; equal [{CARD}]")
    time_batch_inv(f, with_zero_rows(a), n)
    for log_n in (18, 19, 20, 21, 22):
        eng = ntt_engine(log_n, dev)
        x = random_elements(f, eng.n - 4, gen, dev)
        kernels.reset_counts()
        eng.ntt(x)
        launches = kernels.launch_counts()["ntt"]
        k, got = events_ms(lambda: eng.ntt(x))
        p, want = timed(lambda: eng.ntt_plain(x))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"K2 NTT 2^{log_n}: err {err}")
        fold_err(results["ntt"], err)
        # the whole NTT: (n/2) log2(n) butterflies of one Fr product; the
        # input, the output and n/2 twiddles moved once
        bound = {}
        set_bound(bound, (2 * eng.n + eng.n // 2) * 32,
                  eng.n // 2 * log_n * FR_PRODUCT)
        say(f"[time] NTT 2^{log_n}: kernel {k:.4f} ms (events, {launches} "
            f"launches, passes {eng.widths}), bound {bound['bound_ms']:.4f} "
            f"ms ({bound['bound_by']}), plain {p:.3f} ms; equal [{CARD}]")
        if log_n == MAIN_LOG:
            results["ntt"].update(ms=k, plain_ms=p, **bound)
    base = M.points_from_packed(srs_packed, dev)
    for log_n in (19, 20, 21, 22):
        n = 1 << log_n
        main = log_n == MAIN_LOG
        plain = log_n in PLAIN_MSM_LOGS
        # the 2^16 SRS powers repeated: repeats exercise the doubling branch
        points = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
        scalars = random_elements(f, n - 4, gen, dev)
        args = msm_inputs(points, scalars)
        k, got = timed(lambda: M.bucket_msm(*args))
        plain_text = "not run"
        if plain:
            p, want = timed(lambda: M.plain_bucket_msm(*args), reps=1)
            err = xyzz_err(got, want)
            if err:
                raise AssertionError(f"K3 at 2^{log_n} points disagrees with "
                                     f"plain")
            fold_err(results["msm"], err)
            plain_text = f"{p:.3f} ms (one run)"
        total, k3_point = timed(lambda: M.msm(points, scalars))
        bound = {}
        set_bound(bound, msm_bytes(n), k3_imads(args))
        if main:
            results["msm"].update(ms=k, plain_ms=p, **bound)
        say(f"[time] MSM 2^{log_n} (c={args[-1]}): K3 {k:.3f} ms (median of "
            f"3), bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}), "
            f"plain {plain_text}, whole msm() {total:.3f} ms; "
            + ("equal points and window sums" if plain else
               "plain not run (the native checks hold K3 past 2^20)")
            + f" [{CARD}]")
        # K4 on the same points and scalars: the index and prover shapes
        d16 = MD.digit_limbs(scalars)
        t_land, plan = timed(lambda: MP.land(d16))
        k, got = timed(lambda: MP.scan_msm(points, plan))
        kinds = landing_kinds(plan)
        plain_text = "not run"
        if plain:
            counted_kinds = kinds
            kinds = {}
            p, want = timed(lambda: MP.plain_scan_msm(points, plan, kinds),
                            reps=1)
            err = xyzz_err(got, want)
            if err:
                raise AssertionError(f"K4 at 2^{log_n} points disagrees with "
                                     f"plain")
            fold_err(results["msm_u8"], err)
            if counted_kinds["add"] != sum(kinds.get(k, 0) for k in
                                           ("add", "dbl", "cancel")):
                raise AssertionError(f"the landing's pairs {counted_kinds} "
                                     f"disagree with the plain levels' "
                                     f"{kinds}")
            plain_text = f"{p:.3f} ms (one run)"
        total, k4_point = timed(lambda: MD.msm_device(points, d16))
        if point_err(k4_point, k3_point):
            raise AssertionError(f"msm_device at 2^{log_n} points disagrees "
                                 f"with msm")
        products, inversions = k4_products(plan, kinds)
        bound = {}
        set_bound(bound, msm_bytes(n), products * FQ_PRODUCT)
        if main:
            results["msm_u8"].update(ms=k, plain_ms=p, **bound)
        lane_scan = {}
        set_bound(lane_scan, msm_bytes(n), lane_scan_imads(d16))
        adds = int(plan.idx.numel()) - int(
            (plan.first[0][1:] > plan.first[0][:-1]).sum())
        say(f"[time] 8-bit MSM 2^{log_n} ({plan.levels} affine levels, "
            f"chunks {plan.geometry[:, 1].tolist()}, threads "
            f"{plan.geometry[:, 2].tolist()}, {plan.merge_passes} XYZZ "
            f"merge levels): K4 {k:.3f} ms, bound "
            f"{bound['bound_ms']:.3f} ms "
            f"({bound['bound_by']}, its Fq products; the former "
            f"lane scan's count {lane_scan['bound_ms']:.3f} ms), plain "
            f"{plain_text}, land {t_land:.3f} ms, whole msm_device() "
            f"{total:.3f} ms; "
            + ("equal points and window sums, " if plain else "")
            + f"MSM equal to K3's [{CARD}]")
        say(f"[time] 8-bit MSM 2^{log_n} work: {adds} bucket adds; Fq "
            f"products {products} ({products / max(1, adds):.3f} an add), "
            f"{inversions} inversions; level items {kinds_text(kinds)}"
            + ("" if plain else " (from the landing: pairs as adds)"))


MAIN_PATH = ("fr_ops", "ntt", "msm", "msm_u8")
PROVE_PATH = ("fr_ops", "ntt", "msm")        # a prove on the default engine
INDEX_PATH = ("fr_ops", "ntt", "msm_u8")     # an index


def require_launched(counts: dict, names, where: str) -> None:
    missing = [name for name in names if counts[name] <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched in {where}")


def warm_prove(pk, label: str):
    """One timed zk prove through api.encrypt; (proof, launches in it)."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    proof = traced(lambda: api.encrypt(MESSAGE, KEY, pk, rng=random.Random(2),
                                       zk=True))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    counts = {k: after[k] - before[k] for k in after}
    say(f"[main] warm prove (zk, {label}): {warm_s:.2f}s; stages "
        f"{stage_text()} [{CARD}]")
    say(f"[main] launches in it: {counts}")
    return proof, counts


def pallas_engine_key(pk, message: bytes = MESSAGE, tag: str = "main"):
    """A proving key whose prover commits on the K4 engine, chosen the way
    a user chooses it: ZKAES_MSM_MXU=0 when the prover is made."""
    pk4 = dataclasses.replace(pk, _prover=None, _witness=None,
                              _mesh_provers={}, _witness_on={})
    old = os.environ.get("ZKAES_MSM_MXU")
    os.environ["ZKAES_MSM_MXU"] = "0"
    try:
        t0 = time.perf_counter()
        proof = api.encrypt(message, KEY, pk4, rng=random.Random(3), zk=True)
        say(f"[{tag}] cold prove (zk, K4 engine): "
            f"{time.perf_counter() - t0:.1f}s [{CARD}]")
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
        f"{index_counts} [{CARD}]")
    require_launched(index_counts, ("fr_ops", "ntt", "msm_u8"), "the index")

    t0 = time.perf_counter()
    proof = api.encrypt(MESSAGE, KEY, pk, rng=random.Random(1), zk=True)
    say(f"[main] cold prove (zk): {time.perf_counter() - t0:.1f}s [{CARD}]")
    ct = api.compute_ciphertext(MESSAGE, KEY)
    check_proof(vk, proof, ct, "cold")
    say(f"[main] serialize round trip: {round_trip(vk, proof, ct)} bytes, "
        f"verifies")

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

    engines_agree(vk, pk, pk4, MESSAGE, ct, "main")

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
    check_native(pk, dev, "main")
    return pk, vk


# the (message, key) pairs of the entry path, those of
# tests/test_torch_entry.py: FIPS-197 appendix B (and its ciphertext),
# all-zero, all-one, and a pair drawn by numpy from a seed
FIPS_PLAINTEXT = bytes.fromhex("3243f6a8885a308d313198a2e0370734")
FIPS_CIPHERTEXT = bytes.fromhex("3925841d02dc09fbdc118597196a0b32")
ENTRY_PAIRS = {
    "fips197": (FIPS_PLAINTEXT, KEY),
    "zeros": (bytes(16), bytes(16)),
    "ones": (b"\xff" * 16, b"\xff" * 16),
    "seeded": tuple(np.random.default_rng(2026).integers(
        0, 256, 16, dtype=np.uint8).tobytes() for _ in range(2)),
}


def phase_entry(dev) -> None:
    """entry.entry() on the card over the cached 16-byte template: the
    ciphertext bits of every pair equal the AES oracle's with residual 0,
    a flipped witness bit gives a non-zero residual, and the warm
    forward's milliseconds (median of 10, synchronized)."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    forward, args = E.entry(dev)
    setup_s = time.perf_counter() - t0
    for name, (message, key) in ENTRY_PAIRS.items():
        ct_bits, residual = forward(
            torch.tensor(api.bits_lsb_first(message), dtype=torch.int32,
                         device=dev),
            torch.tensor(api.bits_lsb_first(key), dtype=torch.int32,
                         device=dev))
        ct = bytes(encrypt_ecb(message, key))
        if ct_bits.device != dev or ct_bits.tolist() != \
                api.bits_lsb_first(ct):
            raise AssertionError(f"entry: the {name} ciphertext bits differ "
                                 f"from the AES oracle's")
        if int(residual) != 0:
            raise AssertionError(f"entry: the {name} residual is "
                                 f"{int(residual)}, not 0")
    if bytes(encrypt_ecb(*ENTRY_PAIRS["fips197"])) != FIPS_CIPHERTEXT:
        raise AssertionError("entry: the AES oracle misses FIPS-197")
    warm_ms, _ = timed(lambda: forward(*args), reps=10)
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"entry: the forward step launched {counts}")

    tpl = api._template_cached(16)
    stages = {name: st["num_witness_variables"]
              for name, st in tpl.stage_log}
    n_inst, n_cons = tpl.r1cs.num_instance, tpl.r1cs.num_constraints
    positions = {
        "round 1": n_inst + (stages["block 0: after add_round_key round 0"]
                             + stages["block 0: after round 1"]) // 2,
        "key schedule": n_inst + (stages["After allocating the secret key"]
                                  + stages["After deriving the round keys"])
        // 2,
        "ciphertext": 1 + 77,
    }
    message, key = ENTRY_PAIRS["fips197"]
    z = api.WitnessEvaluator(tpl.plan, dev).evaluate(
        {"message": np.asarray(api.bits_lsb_first(message), np.int32),
         "key": np.asarray(api.bits_lsb_first(key), np.int32)})
    coo = E.coo_on(tpl.r1cs, dev)
    flips = {}
    for label, i in positions.items():
        bad = z.clone()
        bad[i] = 1 - bad[i]
        flips[label] = int(E.r1cs_residual(coo, bad, n_cons))
        if flips[label] == 0:
            raise AssertionError(f"entry: a flipped {label} bit (z[{i}]) "
                                 f"leaves the residual 0")
    say(f"[entry] entry() on {dev}: {setup_s:.1f}s to build (template "
        f"cached); {len(ENTRY_PAIRS)} pairs ({', '.join(ENTRY_PAIRS)}) give "
        f"the AES oracle's ciphertext bits with residual 0; flipped witness "
        f"bits give residuals {flips}; warm forward {warm_ms:.2f} ms "
        f"(median of 10); launches {counts} [{CARD}]")


def round_trip(vk, proof, ct: bytes, iv=None) -> int:
    """Serialize, deserialize and verify a proof; its length in bytes."""
    blob = api.serialize_proof(proof)
    back = api.deserialize_proof(blob)
    if api.serialize_proof(back) != blob or not api.verify_encryption(
            vk, back, ct, iv=iv):
        raise AssertionError("serialization round trip failed")
    return len(blob)


def engines_agree(vk, pk, pk4, message: bytes, ct: bytes, tag: str) -> None:
    """zk=False proofs of the K3-engine key and the K4-engine key from one
    seed: equal byte for byte, and verifying."""
    plain3 = api.encrypt(message, KEY, pk, rng=random.Random(4), zk=False)
    plain4 = api.encrypt(message, KEY, pk4, rng=random.Random(4), zk=False)
    blob3, blob4 = api.serialize_proof(plain3), api.serialize_proof(plain4)
    if blob3 != blob4 or not api.verify_encryption(vk, plain4, ct):
        raise AssertionError(f"the zk=False proofs of the two engines differ "
                             f"({tag})")
    say(f"[{tag}] zk=False proofs on K3 and K4 engines: {len(blob3)} bytes, "
        f"equal byte for byte, verify")


def check_native(pk, dev, label: str) -> None:
    """K3 (msm) and K4 (msm_device) at every SRS point of the key (its
    degree + 1 distinct points) against the native Pippenger, outside the
    counted run. The scalars are drawn as numpy limbs (reduced, with the
    edge scalars 0, 1, r - 1 and R mod r at the end)."""
    packed = pk.marlin_pk.srs.powers_g1.packed
    n = packed.shape[0]
    scalars = random_elements(fr_ops(), n - 4, np.random.default_rng(13),
                              dev)
    points = pk._prover.srs_dev.slice(0, n)
    t0 = time.perf_counter()
    got3 = M.msm(points, scalars)
    t1 = time.perf_counter()
    got4 = MD.msm_device(points, MD.digit_limbs(scalars))
    t2 = time.perf_counter()
    want = M.native_msm(packed, scalars)
    t3 = time.perf_counter()
    if point_err(got3, want):
        raise AssertionError(f"K3 at {n} SRS points disagrees with native")
    if point_err(got4, want):
        raise AssertionError(f"K4 at {n} SRS points disagrees with native")
    say(f"[{label}] msm() (K3) and msm_device() (K4) at {n} SRS points equal "
        f"the native Pippenger (card {t1 - t0:.3f}s and {t2 - t1:.3f}s, "
        f"native {t3 - t2:.3f}s) [{CARD}]")


def counted(fn, names, where: str):
    """fn() with the launch counts set to 0 just before and read just
    after; (its result, the counts, wall seconds). Every kernel in `names`
    must have launched."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = traced(fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    require_launched(counts, names, where)
    return out, counts, seconds


# the round spans of the last prove that `traced` ran, in order
ROUNDS: list = []


def traced(fn):
    """fn() with the port's spans on; keeps the round spans of the prove
    that ended last in ROUNDS."""
    spans.enable()
    try:
        return fn()
    finally:
        spans.disable()
        got, _counters = spans.drain()
        proves = [sp for sp in got if sp.name == "prove"]
        last = max(proves, key=lambda sp: sp.t1).id if proves else None
        ROUNDS[:] = sorted((sp for sp in got if sp.proof == last
                            and sp.name.startswith("round.")),
                           key=lambda sp: sp.t0)


def stage_text() -> str:
    """Host seconds of each round of the last prove (the queueing of
    kernels a round launched, and its waits on the card)."""
    return ", ".join(f"{sp.name[len('round.'):]} {(sp.t1 - sp.t0) / 1e9:.3f}s"
                     for sp in ROUNDS)


def stage_memory_text() -> str:
    """Device memory at each round's end of the last prove: allocated /
    the peak so far."""
    return ", ".join(f"{sp.name[len('round.'):]} {gib(sp.attrs['allocated'])}"
                     f" / {gib(sp.attrs['peak'])}" for sp in ROUNDS)


def flipped(data: bytes, byte: int) -> bytes:
    bad = bytearray(data)
    bad[byte] ^= 1
    return bytes(bad)


SMALL_KEYS_DEGREE = 1 << 22    # the SRS degree of the 64-byte key


def start_template_job(cache: str) -> subprocess.Popen:
    """Build and cache the 1 KB ECB template in a process of its own (host
    work of minutes, no card) while the phases before [srs] run. Its last
    line: constraints, SRS degree, build seconds, peak RSS in GiB."""
    code = (
        "import resource, sys, time\n"
        "t0 = time.perf_counter()\n"
        f"from {PKG} import api\n"
        "api.CONFIG.cache_dir = sys.argv[1]\n"
        "tpl = api._template_cached(int(sys.argv[2]), 'ecb')\n"
        "print(tpl.r1cs.num_constraints, api._srs_degree(tpl),\n"
        "      time.perf_counter() - t0,\n"
        "      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, cache, str(KB_BYTES)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_srs(results: dict, job: subprocess.Popen, dev) -> None:
    """The SRS of the largest key of the run (1 KB ECB, degree 2^26),
    through the keys' own entry point api._srs_for on an empty cache:
    generated on the card (K1 for the tau powers and the normalization, K6
    for the ladder) and checkpointed; then its 2^22 prefix checkpointed,
    so that every smaller key truncates that. Three of its powers checked
    by the host pairing e(P_i, h) = e(P_{i-1}, tau_h)."""
    t0 = time.perf_counter()
    out, err = job.communicate()
    waited = time.perf_counter() - t0
    if job.returncode != 0:
        raise AssertionError(f"the 1 KB template job failed:\n{err[-3000:]}")
    constraints, need, build_s, rss = out.split()[-4:]
    need = int(need)
    say(f"[srs] 1 KB ECB template: {constraints} constraints, built and "
        f"cached in {float(build_s):.1f}s (host, a process of its own "
        f"since the run's start, peak RSS {float(rss):.2f} GiB); waited "
        f"{waited:.1f}s for it")
    # the checkpoint's seconds apart from the generation's: _srs_for saves
    # through api._checkpoint_srs, timed here for this one call
    checkpoint, save_s = api._checkpoint_srs, []

    def timed_checkpoint(srs):
        t0 = time.perf_counter()
        checkpoint(srs)
        save_s.append(time.perf_counter() - t0)

    api._checkpoint_srs = timed_checkpoint
    try:
        srs, counts, secs = counted(
            lambda: api._srs_for(need, random.Random(17), dev),
            ("fr_ops", "srs"), "the SRS generation")
    finally:
        api._checkpoint_srs = checkpoint
    if len(save_s) != 1:
        raise AssertionError(f"_srs_for checkpointed {len(save_s)} SRSs, "
                             f"expected its fresh one")
    gen_s = secs - save_s[0]
    results["srs"]["launches"] = counts["srs"]
    t0 = time.perf_counter()
    api._checkpoint_srs(S.truncate_srs(srs, SMALL_KEYS_DEGREE))
    prefix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    powers = srs.powers_g1
    pick = random.Random(23)
    checked = [1] + [pick.randrange(2, need + 1) for _ in range(2)]
    for i in checked:
        if PH.pairing(powers[i], srs.h) != PH.pairing(powers[i - 1],
                                                      srs.tau_h):
            raise AssertionError(f"SRS power {i} fails the pairing check")
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    say(f"[srs] SRS of degree {need} from api._srs_for: generated on the "
        f"card in {gen_s:.1f}s (launches {counts}), checkpointed in "
        f"{save_s[0]:.1f}s, its degree-{SMALL_KEYS_DEGREE} prefix in "
        f"{prefix_s:.1f}s; e(P_i, h) = "
        f"e(P_i-1, tau h) at i = {checked} ({time.perf_counter() - t0:.1f}s, "
        f"host); host peak RSS {rss_gib:.2f} GiB [{CARD}]")


def phase_cbc(dev) -> None:
    """One 16-byte CBC block: the key, a zk proof with its iv, rejection of
    a flipped ciphertext bit and of a flipped iv bit, a round trip."""
    (pk, vk), counts, secs = counted(
        lambda: api.synthesize_keys(16, mode="cbc", device=dev), INDEX_PATH,
        "the CBC index")
    say(f"[cbc] synthesize_keys(16, mode='cbc'): {secs:.1f}s; "
        f"{pk.template.r1cs.num_instance} instance variables, "
        f"n=2^{pk.marlin_pk.log_n}, SRS degree {vk.max_degree}; launches "
        f"{counts} [{CARD}]")
    ct = api.compute_ciphertext(MESSAGE, KEY, iv=IV)
    if ct != api.compute_ciphertext(bytes(m ^ v for m, v in zip(MESSAGE, IV)),
                                    KEY):
        raise AssertionError("one CBC block is not ECB of m xor iv")
    for label, seed in (("cold", 5), ("warm", 6)):
        proof, counts, secs = counted(
            lambda: api.encrypt(MESSAGE, KEY, pk, rng=random.Random(seed),
                                iv=IV), PROVE_PATH, f"the {label} CBC prove")
        say(f"[cbc] {label} prove (zk): {secs:.3f}s; stages {stage_text()};"
            f" launches {counts} [{CARD}]")
    if not api.verify_encryption(vk, proof, ct, iv=IV):
        raise AssertionError("the CBC proof does not verify")
    if api.verify_encryption(vk, proof, flipped(ct, 0), iv=IV):
        raise AssertionError("a flipped ciphertext bit still verifies (CBC)")
    if api.verify_encryption(vk, proof, ct, iv=flipped(IV, 3)):
        raise AssertionError("a flipped iv bit still verifies (CBC)")
    say(f"[cbc] proof verifies with its iv; flipped ciphertext bit and "
        f"flipped iv bit rejected; serialize round trip "
        f"{round_trip(vk, proof, ct, IV)} bytes")


BATCH = 4          # messages of each [batch] line


def transient_check(pk, tag: str) -> str:
    """One warm encrypt on `pk` with the peak reset before it: the bytes
    it held above what was allocated before, which must not exceed the
    reckoned `proof_bytes` that the batch's memory rule counts on."""
    dev = pk.device
    prover = pk._prover
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    api.encrypt(bytes(pk.template.msg_len), KEY, pk, rng=random.Random(5))
    torch.cuda.synchronize(dev)
    held = torch.cuda.max_memory_allocated(dev) - before
    reckoned = proof_bytes(prover.log_n, prover.d_max, prover.msm_engine)
    if held > reckoned:
        raise AssertionError(f"a warm {tag} prove held {gib(held)} above "
                             f"its key, over the {gib(reckoned)} reckoned")
    return (f"a warm prove held {gib(held)} above its key, reckoned "
            f"{gib(reckoned)}")


def phase_batch(pk, vk, tag: str) -> None:
    """encrypt_batch of BATCH messages on `pk` under a seeded rng: the
    depth the memory rule picks here (two on an 80 GB card) and a warm
    prove's bytes against the reckoning; the batch timed twice around the
    same proofs made in turn by encrypt(m_i) from Random(seed i), the
    seeds drawn first from the batch's rng as the JAX package draws them,
    with its launches (exactly the sum of the proofs in turn, BATCH times
    one's) and its peak device memory; each batch proof byte-equal to its
    proof in turn, verified against its own ciphertext and rejected
    against the next message's."""
    dev = pk.device
    msg_len = pk.template.msg_len
    messages = [bytes((7 * i + j) % 256 for j in range(msg_len))
                for i in range(BATCH)]
    depth = api._batch_depth(pk, pk._prover, BATCH)
    say(f"[batch] {tag}: the memory rule keeps {depth} proofs in flight "
        f"({os.cpu_count()} host cores); {transient_check(pk, tag)} "
        f"[{CARD}]")
    if depth != 2:
        raise AssertionError(f"the {tag} batch would prove in turn")

    def batch(label: str):
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        proofs, counts, secs = counted(
            lambda: api.encrypt_batch(messages, KEY, pk,
                                      rng=random.Random(21)),
            PROVE_PATH, f"the {tag} batch")
        peak = torch.cuda.max_memory_allocated(dev)
        say(f"[batch] {tag} encrypt_batch of {BATCH} messages, {label}: "
            f"{secs:.3f}s ({secs / BATCH:.3f}s a proof); launches {counts};"
            f" peak device memory {gib(peak)}, {gib(peak - before)} above "
            f"the key [{CARD}]")
        return proofs, counts, secs

    proofs, counts, first_s = batch("first")
    draw = random.Random(21)
    seeds = [draw.randrange(1 << 62) for _ in messages]
    single_counts, times = [], []
    for i, (m, seed) in enumerate(zip(messages, seeds)):
        single, one_counts, secs = counted(
            lambda: api.encrypt(m, KEY, pk, rng=random.Random(seed)),
            PROVE_PATH, f"the {tag} proof {i} in turn")
        if api.serialize_proof(single) != api.serialize_proof(proofs[i]):
            raise AssertionError(f"{tag} batch proof {i} differs from "
                                 f"encrypt() with its seed")
        single_counts.append(one_counts)
        times.append(secs)
    if any(c != single_counts[0] for c in single_counts) or counts != {
            k: BATCH * v for k, v in single_counts[0].items()}:
        raise AssertionError(f"the {tag} batch launched {counts}, not "
                             f"{BATCH} times a prove's {single_counts}")
    again, counts2, second_s = batch("again")
    if counts2 != counts or [api.serialize_proof(p) for p in again] != [
            api.serialize_proof(p) for p in proofs]:
        raise AssertionError(f"the second {tag} batch differs from the "
                             f"first")
    say(f"[batch] {tag}: the {BATCH} proofs in turn through encrypt() from "
        f"their seeds: " + ", ".join(f"{t:.3f}" for t in times)
        + f"s, sum {sum(times):.3f}s, against the batch's {first_s:.3f}s "
        f"and {second_s:.3f}s; each batch proof equal byte for byte, "
        f"launches {BATCH} x {single_counts[0]} [{CARD}]")
    cts = [api.compute_ciphertext(m, KEY) for m in messages]
    for i, proof in enumerate(proofs):
        if not api.verify_encryption(vk, proof, cts[i]):
            raise AssertionError(f"{tag} batch proof {i} does not verify")
        if api.verify_encryption(vk, proof, cts[(i + 1) % BATCH]):
            raise AssertionError(f"{tag} batch proof {i} verifies against "
                                 f"another message's ciphertext")
    say(f"[batch] {tag}: every proof verifies; each is rejected against "
        f"the next message's ciphertext")


def phase_32b(dev) -> None:
    """Two 16-byte CBC blocks, chained (n = 2^19, SRS degree 2^21, a
    prefix of the run's 2^22 checkpoint): the key, a cold and a warm zk
    proof with stage times, verification, rejection of a flipped ciphertext
    bit in the second block; then K3 and K4 at the key's 2^21 + 1 SRS
    points against the native Pippenger."""
    message = bytes(range(32))
    (pk, vk), counts, secs = counted(
        lambda: api.synthesize_keys(32, mode="cbc", device=dev), INDEX_PATH,
        "the 32-byte index")
    times = ", ".join(f"{k} {v:.1f}s" for k, v in pk.setup_times.items())
    say(f"[32B] synthesize_keys(32, mode='cbc'): {secs:.1f}s ({times}); "
        f"n=2^{pk.marlin_pk.log_n}, k=2^{max(vk.log_ks)}, SRS degree "
        f"{vk.max_degree}; launches {counts} [{CARD}]")
    for label, seed in (("cold", 7), ("warm", 8)):
        proof, counts, secs = counted(
            lambda: api.encrypt(message, KEY, pk, rng=random.Random(seed),
                                iv=IV), PROVE_PATH,
            f"the {label} 32-byte prove")
        say(f"[32B] {label} prove (zk): {secs:.3f}s; stages "
            f"{stage_text()}; launches {counts} [{CARD}]")
    ct = api.compute_ciphertext(message, KEY, iv=IV)
    if not api.verify_encryption(vk, proof, ct, iv=IV):
        raise AssertionError("the 32-byte CBC proof does not verify")
    if api.verify_encryption(vk, proof, flipped(ct, 16), iv=IV):
        raise AssertionError("a flipped bit of the second ciphertext block "
                             "still verifies")
    say("[32B] proof verifies; flipped bit in the second block rejected")
    check_native(pk, dev, "32B")


def gib(nbytes: int) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def phase_64b(dev):
    """Four 16-byte ECB blocks (n = 2^20, largest matrix k = 2^21, round-3
    cosets and SRS of 2^22, the reference's own SRS capacity): the key, a
    cold and a warm zk proof on the K3 engine and a warm one on the K4
    engine with stage times and launches, zk=False proofs of the two
    engines equal byte for byte, verification, rejection of a flipped bit
    in the fourth ciphertext block, a serialization round trip, and the
    card's memory in the index and the proves; then K3 and K4 at the key's
    2^22 + 1 SRS points against the native Pippenger."""
    message = bytes(range(64))
    torch.cuda.reset_peak_memory_stats(dev)
    (pk, vk), counts, secs = counted(
        lambda: api.synthesize_keys(64, device=dev), INDEX_PATH,
        "the 64-byte index")
    times = ", ".join(f"{k} {v:.1f}s" for k, v in pk.setup_times.items())
    shapes = (pk.marlin_pk.log_n, max(vk.log_ks), vk.max_degree)
    say(f"[64B] synthesize_keys(64): {secs:.1f}s ({times}); "
        f"{pk.template.r1cs.num_constraints} constraints, "
        f"{pk.template.r1cs.num_instance} instance variables, n=2^{shapes[0]}, "
        f"k=2^{shapes[1]}, SRS degree {shapes[2]}; launches {counts}; peak "
        f"device memory {gib(torch.cuda.max_memory_allocated(dev))} [{CARD}]")
    if shapes != (20, 21, 1 << 22):
        raise AssertionError(f"the 64-byte key has (log n, log k, degree) "
                             f"{shapes}, not (20, 21, 2^22)")
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    proofs = {}
    for label, seed in (("cold", 9), ("warm", 10)):
        proofs[label], counts, secs = counted(
            lambda: api.encrypt(message, KEY, pk, rng=random.Random(seed)),
            PROVE_PATH, f"the {label} 64-byte prove")
        if counts["msm_u8"]:
            raise AssertionError("the K3-engine prove launched K4")
        say(f"[64B] {label} prove (zk, K3 engine): {secs:.3f}s; stages "
            f"{stage_text()}; launches {counts} [{CARD}]")
    pk4, _cold4 = pallas_engine_key(pk, message, "64B")
    proofs["warm4"], counts, secs = counted(
        lambda: api.encrypt(message, KEY, pk4, rng=random.Random(11)),
        ("fr_ops", "ntt", "msm_u8"), "the 64-byte K4-engine prove")
    if counts["msm"]:
        raise AssertionError("the 64-byte K4-engine prove launched K3")
    say(f"[64B] warm prove (zk, K4 engine): {secs:.3f}s; stages "
        f"{stage_text()}; launches {counts} [{CARD}]")
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"[64B] device memory: {gib(resident)} allocated before the proves "
        f"(every key of the run still held), peak {gib(peak)} in them "
        f"({gib(peak - resident)} above), {gib(torch.cuda.max_memory_reserved(dev))}"
        f" reserved at most [{CARD}]")

    ct = api.compute_ciphertext(message, KEY)
    for label, proof in proofs.items():
        if not api.verify_encryption(vk, proof, ct):
            raise AssertionError(f"the {label} 64-byte proof does not verify")
    if api.verify_encryption(vk, proofs["warm"], flipped(ct, 48)):
        raise AssertionError("a flipped bit of the fourth ciphertext block "
                             "still verifies")
    say(f"[64B] the three proofs verify on the host; flipped bit in the "
        f"fourth block rejected; serialize round trip "
        f"{round_trip(vk, proofs['warm4'], ct)} bytes")
    engines_agree(vk, pk, pk4, message, ct, "64B")
    del pk4
    check_native(pk, dev, "64B")
    return pk, vk


MESH_SHARDS = 4


def batched_k2(dev, mesh) -> str:
    """Batched K2 (ntt_rows, intt_rows) against its batched plain version
    at the four-step shard shapes of the 16-byte, 64-byte and 1 KB 4n
    domains (both passes of each take the same shape: the splits are
    even), bit-exact; the 1 KB shape timed against its bound."""
    f = fr_ops()
    gen = np.random.default_rng(11)
    shapes = []
    for log_nn in (20, 22, 26):
        log_n1, log_n2 = SN.four_step_split(log_nn, mesh.size)
        rows, log_n = (1 << log_n1) // mesh.size, log_n2
        eng = ntt_engine(log_n, dev)
        x = random_elements(f, rows * eng.n - 4, gen, dev).view(
            rows, eng.n, f.L)
        err = max(max_abs_err(eng.ntt_rows(x), eng.ntt_rows_plain(x)),
                  max_abs_err(eng.intt_rows(x), eng.intt_rows_plain(x)))
        if err:
            raise AssertionError(f"batched K2 [{rows}, 2^{log_n}]: err {err}")
        shapes.append(f"[{rows}, 2^{log_n}]")
    kernels.reset_counts()
    eng.ntt_rows(x)
    launches = kernels.launch_counts()["ntt"]
    k, _ = events_ms(lambda: eng.ntt_rows(x))
    p, _ = timed(lambda: eng.ntt_rows_plain(x), reps=1)
    flat = ntt_engine((rows * eng.n).bit_length() - 1, dev)
    single, _ = events_ms(lambda: flat.ntt(x.view(-1, f.L)))
    elements = rows * eng.n
    bound = {}
    set_bound(bound, (2 * elements + eng.n // 2) * 32,
              elements // 2 * log_n * FR_PRODUCT)
    say(f"[mesh] batched K2 (ntt_rows, intt_rows) at the shard shapes "
        f"{shapes} of 2^20, 2^22, 2^26 vs batched plain: bit-exact; "
        f"[{rows}, 2^{log_n}]: kernel {k:.4f} ms (events, {launches} "
        f"launches, passes {eng.widths}), bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}), plain {p:.1f} ms (one run); one "
        f"2^{flat.log_n}-point NTT of the same elements {single:.4f} ms "
        f"[{CARD}]")
    return shapes


def sharded_ntts(dev, mesh) -> None:
    """ntt_sharded against the single-device K2 NTT at 2^20, 2^22 and
    2^26, forward and inverse, bit-exact, each timed once (synchronized)."""
    f = fr_ops()
    gen = np.random.default_rng(12)
    times = []
    for log_nn in (20, 22, 26):
        split = SN.four_step_split(log_nn, mesh.size)
        eng = ntt_engine(log_nn, dev)
        x = random_elements(f, eng.n - 4, gen, dev)
        for inverse in (False, True):
            one, want = timed(lambda: eng.intt(x) if inverse else eng.ntt(x),
                              reps=1)
            # the first call builds the shards' twiddles: time the second
            SN.ntt_sharded(mesh, x, *split, inverse=inverse)
            ms, got = timed(lambda: SN.ntt_sharded(mesh, x, *split,
                                                   inverse=inverse), reps=1)
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"ntt_sharded 2^{log_nn} (inverse "
                                     f"{inverse}): err {err}")
            times.append(f"2^{log_nn} {'inverse' if inverse else 'forward'} "
                         f"{ms:.2f} ms (one device {one:.2f} ms)")
        del x, want, got
        SN._twiddles.cache_clear()
        torch.cuda.empty_cache()
    say(f"[mesh] ntt_sharded (split {SN.four_step_split(26, mesh.size)} at "
        f"2^26) equals the single-device K2 NTT bit for bit: "
        + "; ".join(times) + f" [{CARD}]")


def sharded_msms(dev, mesh, points) -> None:
    """msm_sharded against the one-device MSM: K3 at the 64-byte key's
    2^22 + 1 SRS points, K4 at 2^20; the points placed on every card
    first, each side timed by the median of 3 after a warm-up call (the
    first launch on a card loads the kernels there)."""
    replicas = replicated(mesh, points)
    out = []
    for engine, n in (("mxu", points.shape[0]), ("pallas", 1 << 20)):
        scalars = device_scalars(n, 13, dev)
        if engine == "mxu":
            one = lambda: M.msm_point(points, scalars)
        else:
            one = lambda: MD.msm_device_point(points, MD.digit_limbs(scalars))
        sharded = lambda: msm_sharded(mesh, replicas, scalars, engine)
        one()
        sharded()
        one_ms, want = timed(one)
        ms, got = timed(sharded)
        if point_err(M.xyzz_to_affine(got)[0], M.xyzz_to_affine(want)[0]):
            raise AssertionError(f"msm_sharded ({engine}) at {n} points "
                                 f"differs from the one-device MSM")
        out.append(f"{'K3' if engine == 'mxu' else 'K4'} at {n} points "
                   f"{ms:.1f} ms (one device {one_ms:.1f} ms)")
    say("[mesh] msm_sharded equals the one-device MSM (medians of 3 after a "
        "warm-up): " + "; ".join(out) + f" [{CARD}]")


def device_peaks(mesh) -> str:
    return ", ".join(f"{d} {gib(torch.cuda.max_memory_allocated(d))}"
                     for d in dict.fromkeys(mesh.devices))


def mesh_proves(pk, vk, mesh, message: bytes, tag: str, seeds, engine_path,
                launches: dict) -> None:
    """A cold and a warm zk proof through encrypt(mesh=) (the warm one with
    its stages, launches and each card's peak memory), each byte-equal to
    the single-device proof from its seed, verified on the host, a flipped
    bit of the last ciphertext block rejected."""
    ct = api.compute_ciphertext(message, KEY)
    for label, seed in zip(("cold", "warm"), seeds):
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.reset_peak_memory_stats(d)
        proof, counts, secs = counted(
            lambda: api.encrypt(message, KEY, pk, rng=random.Random(seed),
                                mesh=mesh), engine_path,
            f"the {label} {tag} mesh prove")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        prover = pk._mesh_provers[mesh]
        say(f"[mesh] {label} {tag} prove on the mesh (zk, "
            f"{'K4' if prover.msm_engine == 'pallas' else 'K3'} engine): "
            f"{secs:.3f}s; stages {stage_text()}"
            + f"; launches {counts}; peak memory {device_peaks(mesh)} "
            f"[{CARD}]")
        t0 = time.perf_counter()
        single = api.encrypt(message, KEY, pk, rng=random.Random(seed))
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        if api.serialize_proof(single) != api.serialize_proof(proof):
            raise AssertionError(f"the {tag} mesh proof differs from the "
                                 f"single-device proof")
    if not api.verify_encryption(vk, proof, ct):
        raise AssertionError(f"the {tag} mesh proof does not verify")
    if api.verify_encryption(vk, proof, flipped(ct, len(ct) - 16)):
        raise AssertionError(f"a flipped ciphertext bit still verifies "
                             f"({tag} mesh proof)")
    say(f"[mesh] {tag}: both mesh proofs equal the single-device proofs "
        f"byte for byte (single-device warm {one_s:.3f}s); verifies; "
        f"flipped bit in the last block rejected")


def phase_mesh(results: dict, dev, pk16, vk16, pk64, vk64) -> None:
    """A mesh of MESH_SHARDS shards on cuda:(i mod the card count): batched
    K2 against its plain version, ntt_sharded and msm_sharded against one
    device, encrypt(mesh=) at 16 and 64 bytes on K3 and at 16 bytes on K4,
    each proof byte-equal to the single-device one, verified and
    tamper-rejected; encrypt_batch(mesh=) of four 16-byte messages, each
    proof equal to encrypt's from its seed; then dryrun_multichip. The
    launches of the mesh proves and the batch are the JSON's
    mesh_launches."""
    count = torch.cuda.device_count()
    mesh = make_mesh(devices=[torch.device("cuda", i % count)
                              for i in range(MESH_SHARDS)])
    cards = list(dict.fromkeys(mesh.devices))
    peers = {f"{a.index}->{b.index}": torch.cuda.can_device_access_peer(a, b)
             for a in cards for b in cards if a != b}
    say(f"[mesh] {mesh.size} shards on {[str(d) for d in mesh.devices]}; "
        f"peer access {peers or 'none needed (one card)'} [{CARD}]")
    batched_k2(dev, mesh)
    sharded_ntts(dev, mesh)
    sharded_msms(dev, mesh, pk64._prover.srs_dev.points)

    launches = {}
    mesh_proves(pk16, vk16, mesh, MESSAGE, "16B", (30, 31), PROVE_PATH,
                launches)
    mesh_proves(pk64, vk64, mesh, bytes(range(64)), "64B", (32, 33),
                PROVE_PATH, launches)
    pk4 = dataclasses.replace(pk16, _prover=None, _witness=None,
                              _mesh_provers={}, _witness_on={})
    old = os.environ.get("ZKAES_MSM_MXU")
    os.environ["ZKAES_MSM_MXU"] = "0"
    try:
        mesh_proves(pk4, vk16, mesh, MESSAGE, "16B K4-engine", (34, 35),
                    ("fr_ops", "ntt", "msm_u8"), launches)
    finally:
        if old is None:
            os.environ.pop("ZKAES_MSM_MXU")
        else:
            os.environ["ZKAES_MSM_MXU"] = old
    if pk4._mesh_provers[mesh].msm_engine != "pallas":
        raise AssertionError("ZKAES_MSM_MXU=0 did not select the K4 engine")
    del pk4

    messages = [bytes(range(i, i + 16)) for i in (0, 40, 80, 120)]
    mesh_provers = dict(pk16._mesh_provers)
    proofs, counts, secs = counted(
        lambda: api.encrypt_batch(messages, KEY, pk16, rng=random.Random(36),
                                  mesh=mesh), PROVE_PATH, "the mesh batch")
    if pk16._mesh_provers != mesh_provers:
        raise AssertionError("encrypt_batch(mesh=) made or replaced a mesh "
                             "prover; it proves on the key's own")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    draw = random.Random(36)
    for i, (m, seed) in enumerate(zip(messages, [draw.randrange(1 << 62)
                                                 for _ in messages])):
        single = api.encrypt(m, KEY, pk16, rng=random.Random(seed))
        if api.serialize_proof(single) != api.serialize_proof(proofs[i]):
            raise AssertionError(f"mesh batch proof {i} differs from "
                                 f"encrypt() with its seed")
        if not api.verify_encryption(vk16, proofs[i],
                                     api.compute_ciphertext(m, KEY)):
            raise AssertionError(f"mesh batch proof {i} does not verify")
    say(f"[mesh] encrypt_batch(mesh=) of {len(messages)} 16-byte messages: "
        f"{secs:.3f}s ({secs / len(messages):.3f}s a proof; the fill on the "
        f"mesh, the proofs on the key's prover, mesh provers unchanged); "
        f"launches {counts}; each proof equals encrypt() from its seed and "
        f"verifies [{CARD}]")
    for name in results:
        results[name]["mesh_launches"] = launches.get(name, 0)
    require_launched(launches, ("fr_ops", "ntt", "msm", "msm_u8"),
                     "the mesh proves")
    say(f"[mesh] launches in the mesh proves and the batch: {launches}")
    pk16._mesh_provers.clear()
    pk64._mesh_provers.clear()
    dryrun_multichip(MESH_SHARDS, "cuda", say=lambda line: say(
        f"[mesh] {line}"))


def device_scalars(n: int, seed: int, dev) -> torch.Tensor:
    """[n, 8] reduced standard-form Fr limbs drawn on the card (the top
    limb below r's)."""
    f = fr_ops()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-2**31, 2**31, (n, f.L), dtype=torch.int32,
                      generator=g, device=dev)
    x[:, -1] = torch.randint(0, f.modulus >> (32 * (f.L - 1)), (n,),
                             dtype=torch.int32, generator=g, device=dev)
    return x


def check_groups(pk, label: str) -> None:
    """Grouped MSMs at the 1 KB key's sizes, outside the counted run: K3
    and K4 at 2^25 + 1 SRS points (two and five window groups) equal to
    each other, and K3 at all 2^26 + 1 points (four groups) equal to the
    sum of K3 over its two halves."""
    points = pk._prover.srs_dev.points
    n = (1 << 25) + 1
    sc = device_scalars(n, 31, points.device)
    t0 = time.perf_counter()
    got3 = M.msm(points[:n], sc)
    t1 = time.perf_counter()
    got4 = MD.msm_device(points[:n], MD.digit_limbs(sc))
    t2 = time.perf_counter()
    if point_err(got3, got4):
        raise AssertionError(f"K3 and K4 differ at {n} SRS points")
    n = points.shape[0]
    sc = device_scalars(n, 32, points.device)
    t3 = time.perf_counter()
    whole = M.msm(points, sc)
    t4 = time.perf_counter()
    h = n // 2
    halves = M.msm(points[:h], sc[:h]).add(M.msm(points[h:], sc[h:]))
    if point_err(whole, halves):
        raise AssertionError(f"K3 at {n} SRS points differs from the sum "
                             f"over its halves")
    m = (1 << 25) + 1
    say(f"[{label}] msm() (K3) and msm_device() (K4) at {m} SRS points "
        f"equal ({t1 - t0:.3f}s and {t2 - t1:.3f}s, window groups "
        f"{M.window_groups(20, m, M.PAIR_BYTES, M.GROUP_BYTES)} and "
        f"{M.window_groups(MP.WINDOWS, m, MP.PAIR_BYTES, M.GROUP_BYTES)}); "
        f"K3 at {n} points ({t4 - t3:.3f}s, groups "
        f"{M.window_groups(20, n, M.PAIR_BYTES, M.GROUP_BYTES)}) equals the "
        f"sum of K3 over its halves [{CARD}]")


def phase_1kb(dev) -> None:
    """64 ECB blocks (n = 2^24, matrices up to k = 2^25, round-2 and
    round-3 cosets and SRS of 2^26): the key (its index committed on K4 in
    window groups), a cold and a warm zk proof on the K3 engine and a warm
    one on the K4 engine with stage times and launches, verification on the
    host, rejection of a flipped bit in the 64th ciphertext block, a
    serialization round trip and the card's memory; then the grouped MSMs
    at the key's sizes (`check_groups`)."""
    message = bytes(range(256)) * 4
    torch.cuda.reset_peak_memory_stats(dev)
    (pk, vk), counts, secs = counted(
        lambda: api.synthesize_keys(KB_BYTES, device=dev), INDEX_PATH,
        "the 1 KB index")
    times = ", ".join(f"{k} {v:.1f}s" for k, v in pk.setup_times.items())
    shapes = (pk.marlin_pk.log_n, max(vk.log_ks), vk.max_degree)
    say(f"[1KB] synthesize_keys({KB_BYTES}): {secs:.1f}s ({times}); "
        f"{pk.template.r1cs.num_constraints} constraints, "
        f"{pk.template.r1cs.num_instance} instance variables, n=2^{shapes[0]}, "
        f"k=2^{vk.log_ks}, SRS degree {shapes[2]}; launches {counts}; peak "
        f"device memory {gib(torch.cuda.max_memory_allocated(dev))} [{CARD}]")
    if shapes != (24, 25, 1 << 26):
        raise AssertionError(f"the 1 KB key has (log n, log k, degree) "
                             f"{shapes}, not (24, 25, 2^26)")
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    proofs, peaks = {}, []
    for label, seed in (("cold", 24), ("warm", 25)):
        # the warm prove's own peak, from what was allocated before it
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        proofs[label], counts, secs = counted(
            lambda: api.encrypt(message, KEY, pk, rng=random.Random(seed)),
            PROVE_PATH, f"the {label} 1 KB prove")
        if counts["msm_u8"]:
            raise AssertionError("the K3-engine prove launched K4")
        say(f"[1KB] {label} prove (zk, K3 engine): {secs:.3f}s; stages "
            f"{stage_text()}; launches {counts} [{CARD}]")
        say(f"[1KB] {label} prove's device memory at each stage's end "
            f"(allocated / peak so far): {stage_memory_text()}")
    held = torch.cuda.max_memory_allocated(dev) - before
    peak = max(peaks + [torch.cuda.max_memory_allocated(dev)])
    say(f"[1KB] device memory: {gib(resident)} allocated before the proves "
        f"(the key, its prover and every earlier key of the run), peak "
        f"{gib(peak)} in the K3-engine proves ({gib(peak - resident)} "
        f"above), {gib(torch.cuda.max_memory_reserved(dev))} reserved at "
        f"most [{CARD}]")
    # no local name for the prover: the K4-engine prove below needs its
    # memory once `pk._prover` is dropped
    reckoned = proof_bytes(pk._prover.log_n, pk._prover.d_max,
                           pk._prover.msm_engine)
    depth = api._batch_depth(pk, pk._prover, 2)
    say(f"[1KB] the warm prove held {gib(held)} above its key, reckoned "
        f"{gib(reckoned)}; encrypt_batch's memory rule keeps {depth} proof "
        f"in flight [{CARD}]")
    if held > reckoned or depth != 1:
        raise AssertionError(f"a 1 KB prove held {gib(held)} against "
                             f"{gib(reckoned)} reckoned; depth {depth}")
    ct = api.compute_ciphertext(message, KEY)
    t0 = time.perf_counter()
    for label, proof in proofs.items():
        if not api.verify_encryption(vk, proof, ct):
            raise AssertionError(f"the {label} 1 KB proof does not verify")
    if api.verify_encryption(vk, proofs["warm"], flipped(ct, 63 * 16)):
        raise AssertionError("a flipped bit of the 64th ciphertext block "
                             "still verifies")
    say(f"[1KB] both proofs verify on the host; flipped bit in the 64th "
        f"block rejected ({time.perf_counter() - t0:.1f}s for three "
        f"verifications); serialize round trip "
        f"{round_trip(vk, proofs['warm'], ct)} bytes")
    check_groups(pk, "1KB")
    # the K4-engine prover replaces the K3-engine one on the card
    pk._prover = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pk4, _cold4 = pallas_engine_key(pk, message, "1KB")
    proof4, counts, secs = counted(
        lambda: api.encrypt(message, KEY, pk4, rng=random.Random(26)),
        ("fr_ops", "ntt", "msm_u8"), "the 1 KB K4-engine prove")
    if counts["msm"]:
        raise AssertionError("the 1 KB K4-engine prove launched K3")
    if not api.verify_encryption(vk, proof4, ct):
        raise AssertionError("the 1 KB K4-engine proof does not verify")
    say(f"[1KB] warm prove (zk, K4 engine): {secs:.3f}s; stages "
        f"{stage_text()}; launches {counts}; verifies; peak device "
        f"memory {gib(torch.cuda.max_memory_allocated(dev))} [{CARD}]")


def build_chain(num_gates: int):
    """scripts/run_plonk_device.py:25 on the port's PlonkCircuit: public out;
    private x; x_{i+1} = x_i^2 + x_i with copy constraints; out = the last.
    (circuit, assignment, out)."""
    c = PlonkCircuit()
    out_pub = c.public_input()
    x = c.var()
    assign = {x: 3}
    cur, val = x, 3
    while len(c.gates) < num_gates - 2:
        sq = c.mul(cur, cur)
        assign[sq] = val * val % R_MOD
        s = c.add(sq, cur)
        assign[s] = (val * val + val) % R_MOD
        cur, val = s, (val * val + val) % R_MOD
    c.assert_equal(cur, out_pub)
    return c, assign, val


def phase_plonk(dev) -> None:
    """One AES-128 block proved with Plonk on the card; the host verifies it
    and rejects a flipped ciphertext bit. Then a 2^12-gate chain, whose card
    proof must equal the host prover's from the same seed."""
    t0 = time.perf_counter()
    ac = AesPlonkCircuit()
    data = ac.circuit.compile()
    gates = len(ac.circuit.gates)
    say(f"[plonk] AES-128 circuit: {gates} gates, n=2^{data.log_n}, "
        f"{data.num_public} public inputs; built and compiled in "
        f"{time.perf_counter() - t0:.1f}s (host) [{CARD}]")
    if (gates, data.n) != (272_544, 1 << 19):
        raise AssertionError(f"AES-Plonk has {gates} gates, n={data.n}")
    t0 = time.perf_counter()
    srs = api._srs_for(data.n + 8, random.Random(17))
    t1 = time.perf_counter()
    pk = plonk.setup(ac.circuit, srs=srs)
    t2 = time.perf_counter()
    prover = TorchPlonkProver(pk, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    say(f"[plonk] SRS truncated to degree {srs.max_degree} {t1 - t0:.1f}s; "
        f"host setup {t2 - t1:.1f}s (8 interpolations and commitments); "
        f"prover init on the card {t3 - t2:.1f}s (9 cosets of "
        f"2^{data.log_n + 2}) [{CARD}]")
    ct = api.compute_ciphertext(MESSAGE, KEY)
    public = ac.public_values(ct)
    t0 = time.perf_counter()
    assign = ac.assign(MESSAGE, KEY)
    t1 = time.perf_counter()
    cols = ac.circuit.wire_columns(assign, public)
    t2 = time.perf_counter()
    rows = [field_rows(col, dev) for col in cols]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    f = fr_ops()
    rows_int = [f.from_ints(col, dev) for col in cols]
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    if not all(torch.equal(a, b) for a, b in zip(rows, rows_int)):
        raise AssertionError("field_rows and from_ints disagree on the wires")
    say(f"[plonk] witness replay {t1 - t0:.2f}s, wire_columns {t2 - t1:.2f}s "
        f"(host); the three columns to Montgomery rows on the card through "
        f"from_small {t3 - t2:.3f}s, through from_ints {t4 - t3:.3f}s, "
        f"equal [{CARD}]")
    for label, seed in (("cold", 12), ("warm", 13)):
        proof, counts, secs = counted(
            lambda: prover.prove(assign, public, ac.circuit,
                                 rng=random.Random(seed)), PROVE_PATH,
            f"the {label} AES-Plonk prove")
        say(f"[plonk] {label} prove (zk): {secs:.3f}s; stages "
            f"{stage_text()}; launches {counts} [{CARD}]")
    t0 = time.perf_counter()
    if not plonk.verify(pk.vk, proof, public):
        raise AssertionError("the AES-Plonk proof does not verify")
    t1 = time.perf_counter()
    if plonk.verify(pk.vk, proof, ac.public_values(flipped(ct, 0))):
        raise AssertionError("a flipped ciphertext bit still verifies "
                             "(AES-Plonk)")
    say(f"[plonk] proof verifies on the host ({t1 - t0:.2f}s); flipped "
        f"ciphertext bit rejected [{CARD}]")

    c, assign, out = build_chain(1 << 12)
    t0 = time.perf_counter()
    pk = plonk.setup(c, srs=api._srs_for(c.compile().n + 8,
                                         random.Random(17)))
    t1 = time.perf_counter()
    want = plonk.prove(pk, assign, [out], c, rng=random.Random(14))
    t2 = time.perf_counter()
    got, counts, secs = counted(
        lambda: TorchPlonkProver(pk, device=dev).prove(
            assign, [out], c, rng=random.Random(14)), PROVE_PATH,
        "the chain prove")
    if got != want:
        raise AssertionError("the chain proof on the card differs from the "
                             "host prover's")
    if not plonk.verify(pk.vk, got, [out]):
        raise AssertionError("the chain proof does not verify")
    say(f"[plonk] chain of {len(c.gates)} gates (n=2^{pk.data.log_n}): "
        f"host setup {t1 - t0:.1f}s, host prove {t2 - t1:.1f}s, card init "
        f"and prove {secs:.3f}s; launches {counts}; all 9 commitments and 6 "
        f"evaluations equal the host prover's; verifies [{CARD}]")


def timed_phase(name: str, fn, *args):
    """fn(*args), then a line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[seconds] {name}: {time.perf_counter() - t0:.1f}s")
    return out


def run(smi: str, job: subprocess.Popen) -> None:
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()

    # library_ms: no single PyTorch call computes a Montgomery product, a
    # finite-field NTT, a G1 MSM or a fixed-base G1 ladder
    results = {name: {"name": name, "route": "cuda",
                      "source": f"{PKG}/{src}", "replaces": rep,
                      "library_ms": None}
               for name, (src, rep) in KERNEL_INFO.items()}
    gen = np.random.default_rng(0)
    timed_phase("K1", check_field, results, gen, dev, 1 << 20)
    timed_phase("K2", check_ntt, results, gen, dev,
                (1, 5, 10, 11, 12, 18, 19, 20, 21, 22))
    t0 = time.perf_counter()
    srs = generate_srs_native((1 << 16) - 1, random.Random(3))
    say(f"[K3] 2^16 test points from the native SRS generator: "
        f"{time.perf_counter() - t0:.1f}s (host)")
    packed = srs.powers_g1.packed
    timed_phase("K3", check_msm, results, packed, dev)
    timed_phase("K4", check_msm_u8, results, packed, dev)
    timed_phase("K5", check_fq_cols, results, gen, dev)
    timed_phase("K6", check_fixed_base, results, srs, dev)
    timed_phase("time", time_kernels, results, packed, gen, dev)
    timed_phase("ntt_mul", phase_ntt_mul, results, gen, dev)
    timed_phase("srs", phase_srs, results, job, dev)
    pk, vk = timed_phase("main", phase_main_path, results, dev)
    timed_phase("entry", phase_entry, dev)
    timed_phase("cbc", phase_cbc, dev)
    timed_phase("batch", phase_batch, pk, vk, "16B")
    timed_phase("32B", phase_32b, dev)
    pk64, vk64 = timed_phase("64B", phase_64b, dev)
    timed_phase("batch64", phase_batch, pk64, vk64, "64B")
    timed_phase("mesh", phase_mesh, results, dev, pk, vk, pk64, vk64)
    del pk64, vk64
    torch.cuda.empty_cache()
    timed_phase("1KB", phase_1kb, dev)
    torch.cuda.empty_cache()
    timed_phase("plonk", phase_plonk, dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mesh_launches")
    for entry in results.values():
        missing = [k for k in keys if k not in entry]
        if missing:
            raise AssertionError(f"kernel {entry['name']} lacks {missing}")
        wrong = [k for k in ("launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms")
                 if not isinstance(entry[k], (int, float))]
        if wrong:
            raise AssertionError(f"kernel {entry['name']}: {wrong} not numbers")
    say(f"[total] build and every phase: "
        f"{time.perf_counter() - t_start:.0f}s [{CARD}]")
    say(json.dumps({"kernels": [results[k] for k in KERNEL_INFO]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    smi = phase_device()
    cache = tempfile.mkdtemp(prefix="zkaes-smoke-")
    api.CONFIG.cache_dir = cache    # templates, SRS, keys, native library
    free = shutil.disk_usage(cache).free
    say(f"[device] cache {cache}: {gib(free)} free on its disk; host "
        f"{gib(os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES'))} "
        f"of memory, {os.cpu_count()} cores")
    job = start_template_job(cache)
    try:
        run(smi, job)
    finally:
        if job.poll() is None:
            job.kill()
        job.wait()
        shutil.rmtree(cache, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
