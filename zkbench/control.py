"""Run a cell's control, or a planted fault, on several seeds in one process.

    python3 zkbench/control.py --workload ecb16.single --seconds 10 \
        --fault wrong_statement --seeds 11 12 13

Each seed is one run of the cell as `run.py` makes it (set-up once: the
key stays loaded between the seeds), with the program wrapped in
`faults.Faulty(kind)`; `--fault none` runs the program as it is. It
prints one line a seed: the seed, `correct`, and every check's number
beside its limit. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench import manifest, run  # noqa: E402
from zkbench.faults import KINDS, Faulty  # noqa: E402


class Kept:
    """The program, kept loaded from one seed to the next."""

    def __init__(self, program):
        self.program = program

    def __getattr__(self, name):
        return getattr(self.program, name)

    def free(self) -> None:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=KINDS + ("none",), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload, trace=False)
    run.set_environment(cell.config)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return run.NO_CARD
    from zkbench.program import Program
    from zkbench.reference import make_reference

    program = Kept(Program(cell.config))
    wrapped = program if args.fault == "none" else Faulty(program,
                                                          args.fault)
    reference = make_reference(cell.config, run.cache_dir(cell.config))
    print(f"[control] {run.card_line()}; {cell.name}, fault {args.fault}",
          flush=True)
    for seed in args.seeds:
        result, _lines = run.run_cell(cell, seed, args.seconds, False,
                                      wrapped, reference, time.perf_counter())
        print(f"[control] seed {seed}: correct {result['correct']}, "
              f"attempted {result['attempted']}, failed {result['failed']}, "
              f"checks {json.dumps(result['checks'])}, metrics "
              f"{json.dumps(result['metrics'])}", flush=True)
    program.program.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
