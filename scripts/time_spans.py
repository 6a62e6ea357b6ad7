"""What the port's spans cost when on: proofs a second of a benchmark
cell's closed loop, in pairs of windows with `utils.spans` on and off.

    python3 scripts/time_spans.py --cell ecb16.single [--pairs 5]
        [--seconds 20] [--seed 7]

Runs on a CUDA card. The cell's configuration and traffic mix are the
benchmark's (`BENCHMARK.json`, `zkbench/`): the port's environment as
`zkbench/run.py` sets it, the proving key, one warm call, then `--pairs`
pairs of windows, one with the facility on and one off (which goes first
alternates), each a closed loop of the mix's calls for `--seconds` (a call
that starts inside a window is finished, and the window ends with it);
the spans a window recorded are drained and dropped after it. The
profiler never runs. Prints each window's proofs a second and spans, and
each side's median and quartiles (`statistics.quantiles(n=4)`), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkbench import manifest, run, traffic  # noqa: E402


def window(program, mix, calls, seconds: float, sync) -> float:
    """Proofs a second of one closed-loop window."""
    proofs, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        proofs += len(program.call(mix, next(calls)))
        sync()
    return proofs / (time.perf_counter() - t0)


def quartiles(values) -> str:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return f"median {q2:.4f}, quartiles {q1:.4f} .. {q3:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    cell = manifest.cell(args.cell, False)
    run.set_environment(cell.config)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_spans: no CUDA card")
    from aes_zero_knowledge_proof_circuit_tpu_torch.utils import spans
    from zkbench.program import Program

    print(f"{args.cell}: {run.card_line()}", flush=True)
    program = Program(cell.config)
    program.setup()
    warm = traffic.calls(cell.mix, cell.config.msg_len, args.seed, "warmup")
    program.call(cell.mix, next(warm))
    torch.cuda.synchronize()
    calls = traffic.calls(cell.mix, cell.config.msg_len, args.seed)
    rates = {"on": [], "off": []}
    for pair in range(args.pairs):
        for side in (("on", "off") if pair % 2 == 0 else ("off", "on")):
            (spans.enable if side == "on" else spans.disable)()
            rate = window(program, cell.mix, calls, args.seconds,
                          torch.cuda.synchronize)
            spans.disable()
            recorded, counters = spans.drain()
            rates[side].append(rate)
            print(f"pair {pair} {side}: {rate:.4f} proofs/s, "
                  f"{len(recorded)} spans, {counters}", flush=True)
    for side, values in rates.items():
        print(f"{args.cell} spans {side}: {quartiles(values)} proofs/s "
              f"over {len(values)} windows", flush=True)
    on, off = (statistics.median(rates[s]) for s in ("on", "off"))
    print(f"{args.cell}: on / off {on / off:.4f}", flush=True)
    program.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
