"""Profile one warm prove of the PyTorch port on a CUDA card.

    python3 scripts/profile_torch_prove.py [--bytes 16] [--mode ecb]
        [--warm 3] [--mesh N] [--batch N] [--out FILE]

Builds the proving key on the card (`synthesize_keys(BYTES, mode=MODE,
device="cuda")`, cached on disk after the first run; a CBC key proves with
a fixed iv), runs `--warm` unprofiled proves of a BYTES-long message, then
one prove under `torch.profiler` with CPU and CUDA activities. With
`--mesh N` those proves run on a mesh of N shards on the visible cards
(cuda:(i mod their count), `encrypt(mesh=)`): first one prove on the key's
card alone, kept as the reference, then its prover is dropped and the mesh
proves from the same seed, which must equal it byte for byte, verify, and
fail against a flipped bit of the last ciphertext block. With `--batch N`
(ECB, no mesh) the profiled run is one `encrypt_batch` of N messages (two
proofs in flight where its memory rule allows, one CUDA stream each),
after one unprofiled batch, and a thread samples the proving threads'
Python stacks every millisecond meanwhile. It prints:

- the card's name and power limit (nvidia-smi), the key's shapes and the
  warm prove seconds;
- the profiled prove's wall seconds and its rounds (`round.*` spans,
  `utils/spans.py`, on for every prove here): host seconds and the
  allocator's bytes in use and peak at each round's end;
- device busy seconds (the union of every device kernel and copy interval)
  and the device's idle share of the prove's wall time (with a mesh, over
  all its cards, and each card's busy seconds), and each card's peak
  device memory in the profiled prove;
- the zk mask draw of one prove timed alone (`marlin/prover._rand_mont` at
  2n + 1 elements on the key's card: the host's seeded bytes, numpy, the
  copy and two K1 products; the bytes alone beside it), next to the
  profiled prove's `r1_commits`, the stage that holds it;
- one `[group]` line per kernel family (K1, K2, each MSM kernel, torch's
  scan and sort kernels, the rest): device ms, launches and share, each
  the sum of the `[kernel]` lines whose names it matches;
- one `[kernel]` line per device kernel or copy name, sorted by device time;
- with `--batch`, the batch's wall seconds, the depth it ran at, and one
  `[host]` line per sampled place (the innermost frame of the port, or
  the library call it is in), with its share of the samples: where the
  proving threads spend the host's time, and so which host section keeps
  the other proof's kernels waiting.

`--out` also writes the `[kernel]` lines to FILE.
"""

from __future__ import annotations

import argparse
import random
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch import api  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import (  # noqa: E402
    prover as marlin_prover,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans  # noqa: E402

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
IV = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
# (group, substrings of the device kernel name), first match wins
GROUPS = (
    ("K1 field_binop, field_pow, batch_inv",
     ("field_binop", "field_pow", "inv_chunk_prefix", "inv_totals",
      "inv_sweep")),
    ("K2 ntt_pass", ("ntt_pass",)),
    ("K3 segment_accumulate", ("segment_accumulate",)),
    ("K3/K4 segment_merge", ("segment_merge",)),
    ("K3/K4 bucket_reduce", ("bucket_reduce",)),
    ("K3/K4 window_ladder", ("window_ladder",)),
    ("K4 affine_level, window_pairs", ("affine_level", "window_pairs")),
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


def round_seconds(stage: str) -> float:
    return next((sp.t1 - sp.t0) / 1e9 for sp in ROUNDS
                if sp.name == "round." + stage)


def prove(pk, message: bytes, iv, seed: int, mesh=None):
    t0 = time.perf_counter()
    proof = traced(lambda: api.encrypt(message, KEY, pk,
                                       rng=random.Random(seed), zk=True,
                                       iv=iv, mesh=mesh))
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return proof, time.perf_counter() - t0


PKG_DIR = "aes_zero_knowledge_proof_circuit_tpu_torch"


def place(frame) -> str:
    """Where a sampled stack is: its innermost frame of the port (function,
    file and line), and the call it is in beyond the port, if any."""
    inner = frame
    while frame is not None and PKG_DIR not in frame.f_code.co_filename:
        frame = frame.f_back
    if frame is None:
        return f"{inner.f_code.co_name} (outside the port)"
    where = (f"{frame.f_code.co_name} "
             f"{frame.f_code.co_filename.split(PKG_DIR + '/')[-1]}:"
             f"{frame.f_lineno}")
    if inner is not frame:
        where += f" in {inner.f_code.co_name}"
    return where


class StackSampler:
    """Samples every other thread's stack each `period` seconds while
    running: Counter of `place` over the threads busy in the port."""

    def __init__(self, period: float = 1e-3):
        self.period = period
        self.places: Counter = Counter()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        me, main = threading.get_ident(), threading.main_thread().ident
        while not self._stop.wait(self.period):
            for ident, frame in sys._current_frames().items():
                if ident in (me, main):
                    continue
                text = place(frame)
                if "(outside the port)" not in text:
                    self.places[text] += 1
                    self.samples += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def mask_draw_text(log_n: int, dev, r1_commits: float) -> str:
    """The prover's zk mask draw (2n + 1 elements) timed alone on `dev`,
    and the seeded bytes it draws, beside the stage that holds it."""
    count = 2 * (1 << log_n) + 1
    total = count * marlin_prover.RAND_BYTES
    draw = random.Random(7)
    t0 = time.perf_counter()
    for i in range(0, total, marlin_prover.RAND_CHUNK):
        draw.randbytes(min(marlin_prover.RAND_CHUNK, total - i))
    bytes_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    marlin_prover._rand_mont(random.Random(7), count, dev)
    torch.cuda.synchronize(dev)
    mask_s = time.perf_counter() - t0
    return (f"zk mask draw alone (_rand_mont, {count} elements on {dev}): "
            f"{mask_s:.3f}s, of which the seeded bytes {bytes_s:.3f}s; "
            f"r1_commits of the profiled prove {r1_commits:.3f}s")


def stage_text() -> str:
    """Each round of the last prove: host seconds (allocated / peak GiB
    at its end)."""
    return ", ".join(
        f"{sp.name[len('round.'):]} {(sp.t1 - sp.t0) / 1e9:.3f}s "
        f"({sp.attrs['allocated'] / 2**30:.2f} / "
        f"{sp.attrs['peak'] / 2**30:.2f} GiB)" for sp in ROUNDS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bytes", type=int, default=16,
                    help="message length, a multiple of 16")
    ap.add_argument("--mode", choices=("ecb", "cbc"), default="ecb")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--mesh", type=int, default=0,
                    help="prove on a mesh of this many shards (0: no mesh)")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile one encrypt_batch of this many messages "
                         "(0: one encrypt)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.batch and (args.mesh or args.mode != "ecb"):
        raise SystemExit("profile_torch_prove: --batch takes an ECB key "
                         "and no mesh")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_prove: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    message = bytes(i % 256 for i in range(args.bytes))
    iv = IV if args.mode == "cbc" else None
    t0 = time.perf_counter()
    pk, vk = api.synthesize_keys(args.bytes, mode=args.mode, device=dev)
    print(f"synthesize_keys({args.bytes}, mode={args.mode!r}): "
          f"{time.perf_counter() - t0:.1f}s; n=2^{pk.marlin_pk.log_n}, "
          f"k=2^{max(vk.log_ks)}, SRS degree {vk.max_degree}", flush=True)
    ct = api.compute_ciphertext(message, KEY, iv=iv)
    reference, secs = prove(pk, message, iv, 0)           # cold prove
    mesh = None
    if args.mesh:
        print(f"cold prove on {dev} alone: {secs:.3f}s; stages "
              f"{stage_text()}", flush=True)
        pk._prover = None                 # its state would double the card's
        torch.cuda.empty_cache()
        mesh = make_mesh(args.mesh, "cuda")
        proof, secs = prove(pk, message, iv, 0, mesh)
        if api.serialize_proof(proof) != api.serialize_proof(reference):
            raise AssertionError("the mesh proof differs from the "
                                 "single-card proof from the same seed")
        if not api.verify_encryption(vk, proof, ct, iv=iv):
            raise AssertionError("the mesh proof does not verify")
        bad = bytearray(ct)
        bad[-16] ^= 1                     # a bit of the last block
        if api.verify_encryption(vk, proof, bytes(bad), iv=iv):
            raise AssertionError("the mesh proof verifies a flipped bit")
        print(f"cold prove on the mesh {[str(d) for d in mesh.devices]}: "
              f"{secs:.3f}s, equal byte for byte to the single-card proof, "
              f"verifies, a flipped bit of the last block rejected; stages "
              f"{stage_text()}",
              flush=True)
    warm = [prove(pk, message, iv, 1 + i, mesh)[1] for i in range(args.warm)]
    print("warm proves (s): " + ", ".join(f"{s:.3f}" for s in warm)
          + (f"; median {statistics.median(warm):.3f}" if warm else ""))

    cards = range(torch.cuda.device_count()) if mesh else [dev.index]
    sampler = None
    if args.batch:
        messages = [bytes((7 * i + j) % 256 for j in range(args.bytes))
                    for i in range(args.batch)]
        t0 = time.perf_counter()
        api.encrypt_batch(messages, KEY, pk, rng=random.Random(8))
        torch.cuda.synchronize(dev)
        print(f"unprofiled batch of {args.batch}: "
              f"{time.perf_counter() - t0:.3f}s; depth "
              f"{api._batch_depth(pk, pk._prover, args.batch)}", flush=True)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if args.batch:
            with StackSampler() as sampler:
                t0 = time.perf_counter()
                proofs = traced(lambda: api.encrypt_batch(
                    messages, KEY, pk, rng=random.Random(9)))
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            proof = proofs[0]
            ct = api.compute_ciphertext(messages[0], KEY)
        else:
            proof, wall = prove(pk, message, iv, 100, mesh)
    if not api.verify_encryption(vk, proof, ct, iv=iv):
        raise AssertionError("the profiled proof does not verify")
    what = f"batch of {args.batch}" if args.batch else "prove"
    print(f"profiled {what}: {wall:.3f}s wall, verifies; stages "
          + ("(of the proof that finished last) " if args.batch else "")
          + stage_text())

    per_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    per_card = defaultdict(list)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        per_card[e.device_index].append((s, t))
        per_name[e.name][0] += t - s
        per_name[e.name][1] += 1
    busy = busy_us(intervals) / 1e6
    if busy <= 0:
        raise AssertionError("the trace holds no device time")
    device_ms = sum(v[0] for v in per_name.values()) / 1e3
    peaks = ", ".join(
        f"cuda:{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f} GiB"
        for d in cards)
    print(f"device busy {busy:.4f}s of {wall:.4f}s wall: idle "
          f"{100 * (1 - busy / wall):.1f} %; device time summed over "
          f"kernels {device_ms:.3f} ms; peak device memory {peaks}")
    if mesh:
        print("busy by card: " + ", ".join(
            f"cuda:{d} {busy_us(iv_) / 1e6:.4f}s"
            for d, iv_ in sorted(per_card.items())))
    if sampler is not None:
        for where, hits in sampler.places.most_common(25):
            print(f"[host] {100 * hits / sampler.samples:.1f} % of "
                  f"{sampler.samples} samples: {where}")
    # after the peaks are read: the draw allocates on the card
    print(mask_draw_text(pk.marlin_pk.log_n, dev,
                         round_seconds("r1_commits")), flush=True)

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
