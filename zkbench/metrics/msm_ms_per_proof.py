"""Device milliseconds a proof spends in its MSMs: the kernels launched
inside spans around Marlin's `TorchProver._msm` (the digit split and K3 or
K4 with their glue) and Plonk's `TorchPlonkProver._commit_batch` (each
polynomial's K3 MSM, with its limbs' conversion, and the batch's points
brought to affine), over the proofs the traced stretch completed."""

PROVER = "aes_zero_knowledge_proof_circuit_tpu_torch.marlin.prover:TorchProver"
PLONK = ("aes_zero_knowledge_proof_circuit_tpu_torch.plonk.prover:"
         "TorchPlonkProver")


def points(args, kwargs) -> str:
    """`_msm(self, offset, coeffs)`: the MSM's point count."""
    coeffs = args[2] if len(args) > 2 else kwargs["coeffs"]
    return str(coeffs.shape[0])


def batch_points(args, kwargs) -> str:
    """`_commit_batch(self, polys)`: each MSM's point count, joined by
    "+"."""
    polys = args[1] if len(args) > 1 else kwargs["polys"]
    return "+".join(str(p.shape[0]) for p in polys)


SPANS = (("msm", PROVER, "_msm", points),
         ("msm", PLONK, "_commit_batch", batch_points))


def read(run):
    tr = run.trace
    if tr is None or not tr.proofs:
        return None
    kernels = tr.kernels_in("msm")
    if not kernels:
        return None
    return sum(k.end - k.start for k in kernels) * 1e3 / tr.proofs
