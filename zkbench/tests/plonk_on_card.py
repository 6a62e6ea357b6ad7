"""One AES-128 block proved with Plonk on the card, judged by the Plonk
reference as a run's window would be.

    python3 zkbench/tests/plonk_on_card.py [--proofs 3] [--seed 7]

Through the port's own surface (no `proof_system` in its API yet): the
AES-Plonk circuit (`plonk.aes_map`), its SRS from the seed through
`api._srs_for`, the host preprocessing `plonk.setup`, and
`TorchPlonkProver` on the card. It proves `--proofs` messages drawn from
the seed with zk on, the first of them again with every blinding scalar 0
(`toy_plonk.ZeroDraws`) and once more with only z's three scalars 0
(`toy_plonk.ZeroDrawsAt`), writes each in the "ZKAESPLK" v1 layout
(`toy_plonk.plonk_proof_bytes`), and judges them with `judge.judge`
against a `PlonkReference` of its own cache directory: the honest proofs,
the unblinded one, the one with z unblinded, and an honest one with one
bit of an evaluation flipped. One more prove runs under the benchmark's
tracer with the MSM and NTT metrics' spans, and prints what those
metrics read for it. It prints the reference's key derivation and judge
seconds, and exits non-zero where a verdict is not the one expected or
a metric reads nothing. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench import judge, manifest, run  # noqa: E402
from zkbench.metrics import (msm_ms_per_proof, msm_roofline_pct,  # noqa: E402
                             ntt_roofline_pct)
from zkbench.trace import Tracer  # noqa: E402
from zkbench.traffic import Call  # noqa: E402

SRS_SEED = 1604162026
CACHE = ROOT / "build" / "zkbench_cache" / "plonk_on_card"


def say(*args) -> None:
    print("[plonk]", *args, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proofs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    os.environ["ZKAES_CACHE_DIR"] = str(CACHE / "port")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")

    import torch

    if not torch.cuda.is_available():
        say("no CUDA card")
        return run.NO_CARD
    from aes_zero_knowledge_proof_circuit_tpu_torch import api
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk import backend
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.aes_map import (
        AesPlonkCircuit)
    from aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover import (
        TorchPlonkProver)
    from zkbench.reference import PlonkReference
    from zkbench.tests.toy_plonk import (Z_DRAWS, ZeroDraws, ZeroDrawsAt,
                                         plonk_proof_bytes)

    say(run.card_line())
    t0 = time.perf_counter()
    aes = AesPlonkCircuit()
    data = aes.circuit.compile()
    t1 = time.perf_counter()
    srs = api._srs_for(data.n + 8, random.Random(SRS_SEED))
    t2 = time.perf_counter()
    pk = backend.setup(aes.circuit, srs=srs)
    t3 = time.perf_counter()
    prover = TorchPlonkProver(pk, device="cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    say(f"port: circuit {len(aes.circuit.gates)} gates, n=2^{data.log_n}, "
        f"{t1 - t0:.2f} s; SRS of degree {srs.max_degree} {t2 - t1:.2f} s; "
        f"host setup {t3 - t2:.2f} s; prover init {t4 - t3:.2f} s")

    rng = random.Random(f"plonk_on_card/{args.seed}")
    calls = [Call(i, [rng.randbytes(16)], rng.randbytes(16),
                  rng.getrandbits(62)) for i in range(args.proofs)]

    def prove(call, rng=None):
        message = call.messages[0]
        public = aes.public_values(api.compute_ciphertext(message, call.key))
        t = time.perf_counter()
        proof = prover.prove(aes.assign(message, call.key), public,
                             aes.circuit,
                             rng=rng or random.Random(call.rng_seed))
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    _, warm = prove(calls[0])
    proofs, secs = zip(*(prove(c) for c in calls))
    plain, plain_s = prove(calls[0], ZeroDraws())
    plain_z, _ = prove(calls[0], ZeroDrawsAt(calls[0].rng_seed, Z_DRAWS))
    say(f"port: first prove {warm:.3f} s, then " +
        ", ".join(f"{s:.3f}" for s in secs) + f" s; unblinded {plain_s:.3f}"
        f" s; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    metrics = (msm_ms_per_proof, msm_roofline_pct, ntt_roofline_pct)
    tracer = Tracer(metrics, CACHE)
    tracer.install()
    tracer.start()
    with tracer.call(0, 1):
        prove(calls[0])
    tracer.stop()
    traced = type("Run", (), {"trace": tracer.read()})()
    tracer.uninstall()
    readings = {m.__name__.rsplit(".", 1)[1]: m.read(traced)
                for m in metrics}
    msm_spans = [sp.desc for sp in traced.trace.spans.get("msm", [])]
    say(f"traced prove: {len(msm_spans)} msm spans "
        f"({', '.join(msm_spans)}), {len(traced.trace.kernels)} kernels; "
        + "; ".join(f"{k} {v}" for k, v in readings.items()))
    unread = [k for k, v in readings.items() if v is None]
    t = time.perf_counter()
    port_ok = backend.verify(pk.vk, proofs[0], aes.public_values(
        api.compute_ciphertext(calls[0].messages[0], calls[0].key)))
    say(f"port's host verifier (pairings): {port_ok} in "
        f"{time.perf_counter() - t:.2f} s")
    honest = [plonk_proof_bytes(p) for p in proofs]
    unblinded = plonk_proof_bytes(plain)
    unblinded_z = plonk_proof_bytes(plain_z)
    flipped = bytearray(honest[0])
    flipped[12 + 7 * 48] ^= 1                  # eval_a's lowest bit
    port_comms = [None if c.point.inf else (c.point.x, c.point.y)
                  for c in pk.vk.comm_selectors + pk.vk.comm_s_sigma]
    del prover, pk, proofs, plain, plain_z
    torch.cuda.empty_cache()

    config = manifest.Config(name="plonk_on_card", msg_len=16, mode="ecb",
                             msm_engine="mxu", zk=True, srs_seed=SRS_SEED,
                             digest="card", proof_system="plonk")
    reference = PlonkReference(config, CACHE)
    if reference.path.exists():
        reference.path.unlink()
    t = time.perf_counter()
    key = reference.key()
    say(f"reference: key derived in {time.perf_counter() - t:.2f} s (the "
        f"frozen circuit built and compiled, eight columns at tau)")
    # judged as a run judges: a fresh reference, its key from the cache
    reference = PlonkReference(config, CACHE)
    t = time.perf_counter()
    loaded = reference.key()
    say(f"reference: key loaded from its cache in "
        f"{time.perf_counter() - t:.4f} s; its eight commitments equal the "
        f"port's vk: {key.comms == loaded.comms == port_comms}")

    failures = 0
    for label, datas, want in (
            ("honest (the first judged: builds the circuit and the weights)",
             honest, {}),
            ("unblinded", [unblinded], {"not_hiding": 1}),
            ("z unblinded (sampled)", [unblinded_z], {"not_hiding": 1}),
            ("flipped bit", [bytes(flipped)], {"unverified": 1})):
        records = [judge.Record(c, 0.0, 0.0, proofs=[d])
                   for c, d in zip(calls, datas)]
        t = time.perf_counter()
        verdict = judge.judge(records, reference, args.seed)
        secs = time.perf_counter() - t
        expected = {k: want.get(k, 0) for k in judge.LIMITS}
        ok = verdict.counts == expected
        failures += not ok
        say(f"{label}: correct {verdict.correct}, checks "
            f"{verdict.counts}; judged in {secs:.2f} s, "
            f"{secs / len(datas):.2f} s a proof; as expected: {ok}")
    return 1 if (failures or unread or not port_ok
                 or key.comms != port_comms) else 0


if __name__ == "__main__":
    sys.exit(main())
