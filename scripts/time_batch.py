"""Time `api.encrypt_batch`'s two-deep pipeline against the same proofs
made in turn, on one CUDA card.

    python3 scripts/time_batch.py [--bytes 16 64] [--count 4]

For each message length: `synthesize_keys(BYTES)` on the card (cached under
ZKAES_CACHE_DIR), one warm-up prove and one warm-up batch, then, each run
synchronized and timed by the host clock, in this order: COUNT proofs in
turn through `encrypt()`; the batch; the batch with the second proof's
start held back by 0.15, 0.3 and 0.5 of one warm prove's time (a stagger,
so that the two proofs' host and device phases alternate); the batch under
`sys.setswitchinterval` 2e-4, 1e-3 and 2e-2 s (how the interpreter lock is
handed between the two proving threads); the batch again; the proofs in
turn again. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch import api  # noqa: E402

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def staggered(prove_z, delay: float):
    """api._prove_z whose second call starts `delay` seconds late."""
    lock, calls = threading.Lock(), [0]

    def prove(*args, **kwargs):
        with lock:
            calls[0] += 1
            second = calls[0] == 2
        if second:
            time.sleep(delay)
        return prove_z(*args, **kwargs)

    return prove


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bytes", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--count", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_batch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    prove_z = api._prove_z
    for length in args.bytes:
        pk, _vk = api.synthesize_keys(length, device=dev)
        msgs = [bytes((7 * i + j) % 256 for j in range(length))
                for i in range(args.count)]

        def in_turn():
            for i, m in enumerate(msgs):
                api.encrypt(m, KEY, pk, rng=random.Random(i))

        def batch():
            api.encrypt_batch(msgs, KEY, pk, rng=random.Random(3))

        api.encrypt(msgs[0], KEY, pk, rng=random.Random(1))
        batch()
        one = timed(lambda: api.encrypt(msgs[0], KEY, pk,
                                        rng=random.Random(1)))
        depth = api._batch_depth(pk, pk._prover, args.count)
        runs = [("in turn", in_turn, 0.0, None), ("batch", batch, 0.0, None)]
        runs += [(f"batch, second proof {f} of a prove late", batch,
                  f * one, None) for f in (0.15, 0.3, 0.5)]
        runs += [(f"batch, switch interval {sw} s", batch, 0.0, sw)
                 for sw in (2e-4, 1e-3, 2e-2)]
        runs += [("batch", batch, 0.0, None), ("in turn", in_turn, 0.0, None)]
        for name, fn, delay, interval in runs:
            old = sys.getswitchinterval()
            if interval:
                sys.setswitchinterval(interval)
            if delay:
                api._prove_z = staggered(prove_z, delay)
            try:
                secs = timed(fn)
            finally:
                api._prove_z = prove_z
                sys.setswitchinterval(old)
            print(f"[batch] {length}B, {args.count} proofs, depth {depth}, "
                  f"{name}: {secs:.3f}s (one warm prove {one:.3f}s) "
                  f"[{card}]", flush=True)
        del pk
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
