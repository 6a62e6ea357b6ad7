"""Time K1 (field products, batch inversion), K2 (the NTT) and K5 (the Fq
digit-column product) of a tree on a CUDA card.

    python3 scripts/time_field_ntt.py

The script times the tree it sits in, through the public wrappers
(`FieldOps.mul`, `batch_inv`, `inv`, `NTTEngine.ntt` / `intt`), so it runs
unchanged in an older tree unpacked beside this one: to compare two trees
on one card, run each tree's copy of the script in one call, in turns.

Each time is CUDA-event milliseconds a call, over 20 calls after one
warm-up call, queued behind a device sleep so that the events time the card
and not the host's launches (unless the host takes longer than the sleep),
with the launches of one call beside it. Inputs are uniform reduced
elements from a seeded numpy generator, with zero rows at 0, 1000, 1001 and
the last row. Each result is checked cheaply on the card: a * a^-1
is 1 on every nonzero row and zero rows stay zero; the NTT round trip gives
the input back. K5 runs at 2^20 columns of random digits, every fourth
column in band digits up to 318: the kernel alone (the launch `ntt_mul`
makes after its checks; a tree from before `_launch` existed takes the same
launch by hand) and `ntt_mul` whole, whose outputs must agree, and a sample
of columns against host integers. The card's name and power limit come
first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch import kernels  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops import (  # noqa: E402
    msm_ntt_mul as NM,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field import (  # noqa: E402
    fq_ops,
    fr_ops,
)
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.ntt import (  # noqa: E402
    ntt_engine,
)

REPS = 20


def elements(f, n: int, seed: int, dev) -> torch.Tensor:
    limbs = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, f.L),
                                                 dtype=np.uint64)
    limbs[:, -1] %= f.modulus >> (32 * (f.L - 1))
    for i in (0, 1000, 1001, n - 1):
        limbs[i] = 0
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


def events_ms(fn) -> tuple:
    """(CUDA-event ms a call over REPS calls after a warm-up, launches of
    one call, the last result)."""
    fn()
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # ~10 ms at the boost clock
    start.record()
    for _ in range(REPS):
        out = fn()
    end.record()
    end.synchronize()
    busy = {k: v for k, v in launches.items() if v}
    return start.elapsed_time(end) / REPS, busy, out


def check_inverse(f, a, inv) -> None:
    zero = (a == 0).all(dim=1)
    prod = f.mul(a, inv)
    one = f.const("one", a.device).expand_as(a)
    if not (torch.equal(prod[~zero], one[~zero]) and not inv[zero].any()):
        raise AssertionError(f"batch_inv L={f.L} is not an inverse")


def fq_columns(n: int, seed: int) -> np.ndarray:
    gen = np.random.default_rng(seed)
    cols = np.zeros((NM.PAD_IN, n), np.int32)
    cols[:47] = gen.integers(0, 256, size=(47, n), dtype=np.int32)
    cols[:46, ::4] += 63
    return cols


def time_k5(dev) -> None:
    n = 1 << 20
    a = torch.from_numpy(fq_columns(n, 4)).to(dev)
    b = torch.from_numpy(fq_columns(n, 5)).to(dev)
    out = torch.empty_like(a)
    if hasattr(NM, "_launch"):
        alone = lambda: NM._launch(a, b, out)
    else:
        consts = NM._kernel_consts(str(dev))
        alone = lambda: kernels.fq_cols_mul(a.data_ptr(), b.data_ptr(),
                                            consts.data_ptr(), out.data_ptr(),
                                            n)
    ms, launches, _ = events_ms(alone)
    print(f"K5 alone 2^20 columns: {ms:.4f} ms, launches {launches}",
          flush=True)
    ms, launches, got = events_ms(lambda: NM.ntt_mul(a, b))
    print(f"K5 ntt_mul (wrapper) 2^20 columns: {ms:.4f} ms, launches "
          f"{launches}", flush=True)
    if not torch.equal(got, out):
        raise AssertionError("K5 alone and ntt_mul disagree")
    m = 2048
    va, vb, vo = (NM.cols_to_ints(t[:, :m]) for t in (a, b, got))
    if vo != [x * y % NM.Q_MOD for x, y in zip(va, vb)]:
        raise AssertionError("K5 disagrees with host integers")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_field_ntt: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tree = Path(__file__).resolve().parent.parent.name
    print(f"=== {tree}: {kernels.library().path.name} on {smi}", flush=True)
    dev = torch.device("cuda", 0)
    n = 1 << 20
    for f in (fr_ops(), fq_ops()):
        a = elements(f, n, 1, dev)
        b = elements(f, n, 2, dev)
        ms, launches, _ = events_ms(lambda: f.mul(a, b))
        print(f"L={f.L} mul 2^20: {ms:.4f} ms, launches {launches}",
              flush=True)
        ms, launches, inv = events_ms(lambda: f.batch_inv(a))
        check_inverse(f, a, inv)
        print(f"L={f.L} batch_inv 2^20: {ms:.4f} ms, launches {launches}",
              flush=True)
        ms, launches, inv = events_ms(lambda: f.inv(a[:1024]))
        check_inverse(f, a[:1024], inv)
        print(f"L={f.L} inv 1024 rows: {ms:.4f} ms, launches {launches}",
              flush=True)
    f = fr_ops()
    for log_n in (18, 19, 20):
        eng = ntt_engine(log_n, dev)
        x = elements(f, 1 << log_n, 3, dev)
        ms, launches, y = events_ms(lambda: eng.ntt(x))
        print(f"NTT 2^{log_n}: {ms:.4f} ms, launches {launches}", flush=True)
        ms, launches, back = events_ms(lambda: eng.intt(y))
        if not torch.equal(back, x):
            raise AssertionError(f"NTT 2^{log_n} round trip failed")
        print(f"iNTT 2^{log_n}: {ms:.4f} ms, launches {launches}", flush=True)
    time_k5(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
