"""The `[mesh]` phase of chip_smoke.py alone, on the keys it needs.

    python3 scripts/mesh_smoke.py

Builds the kernels, then the 16- and 64-byte ECB keys on cuda:0 (their
SRS generated on the card, in a temporary cache directory removed at the
end) and one 64-byte prove (the phase takes its SRS points from that
key's prover), then runs `chip_smoke.phase_mesh`: a mesh of 4 shards on
cuda:(i mod the card count), every check of the phase, its lines and its
`[seconds]` line. A quicker check of the mesh path than the whole smoke
run (about 4 minutes against 12-15), for instance on a host with four
cards. Exits non-zero without a card or when a check fails.
"""

from __future__ import annotations

import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from aes_zero_knowledge_proof_circuit_tpu_torch import api  # noqa: E402


def main() -> int:
    smi = smoke.phase_device()
    cache = tempfile.mkdtemp(prefix="zkaes-mesh-")
    api.CONFIG.cache_dir = cache
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        t0 = time.perf_counter()
        smoke.phase_build()
        pk16, vk16 = api.synthesize_keys(16, device=dev)
        pk64, vk64 = api.synthesize_keys(64, device=dev)
        api.encrypt(bytes(range(64)), smoke.KEY, pk64, rng=random.Random(1))
        smoke.say(f"[keys] 16- and 64-byte keys and a 64-byte prove: "
                  f"{time.perf_counter() - t0:.1f}s [{smi}]")
        results = {name: {"name": name} for name in smoke.KERNEL_INFO}
        smoke.timed_phase("mesh", smoke.phase_mesh, results, dev, pk16,
                          vk16, pk64, vk64)
        smoke.say("[mesh] mesh_launches " + str(
            {k: v["mesh_launches"] for k, v in results.items()}))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
