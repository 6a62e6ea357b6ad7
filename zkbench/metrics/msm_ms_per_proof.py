"""Device milliseconds a proof spends in its MSMs: the kernels launched
inside spans around `TorchProver._msm` (the digit split and K3 or K4
with their glue), over the proofs the traced stretch completed."""

PROVER = "aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover:TorchProver"


def points(args, kwargs) -> str:
    """`_msm(self, offset, coeffs)`: the MSM's point count."""
    coeffs = args[2] if len(args) > 2 else kwargs["coeffs"]
    return str(coeffs.shape[0])


SPANS = (("msm", PROVER, "_msm", points),)


def read(run):
    tr = run.trace
    if tr is None or not tr.proofs:
        return None
    kernels = tr.kernels_in("msm")
    if not kernels:
        return None
    return sum(k.end - k.start for k in kernels) * 1e3 / tr.proofs
