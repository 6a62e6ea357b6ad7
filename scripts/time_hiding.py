"""The KZG hiding terms on this host's CPU: `kzg.hiding_terms` (the native
library's Pippenger, outside the interpreter lock) against msm_host's Python
Pippenger, at the two sizes a Marlin prove uses (two gamma powers a
commitment, eight an opening), on random 253-bit scalars.

    python3 scripts/time_hiding.py [--reps 20] [--seed 7]

Needs no card. Prints each path's median milliseconds a term at each size,
and whether the two agree on every term.
"""

from __future__ import annotations

import argparse
import os
import platform
import random
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aes_zero_knowledge_proof_circuit_tpu_torch.ops import kzg, msm_host  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.ops.field_params import R_MOD  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch.utils import native  # noqa: E402


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rng = random.Random(args.seed)
    bases = kzg.HidingBases(kzg.setup(1, rng).gamma_powers_g1)
    print(f"host {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} cores, native {native.available()}")
    for n in (2, kzg.HIDING_POWERS):
        fast, slow, same = [], [], True
        for _ in range(args.reps):
            poly = [rng.randrange(R_MOD) for _ in range(n)]
            (a,), ms_a = timed(lambda: kzg.hiding_terms(bases, [poly]))
            b, ms_b = timed(lambda: msm_host._msm_python(bases.points[:n],
                                                         poly))
            fast.append(ms_a)
            slow.append(ms_b)
            same = same and a == b
        print(f"{n} points: hiding_terms {statistics.median(fast):.3f} ms, "
              f"_msm_python {statistics.median(slow):.3f} ms "
              f"(medians of {args.reps}); equal {same}")


if __name__ == "__main__":
    main()
