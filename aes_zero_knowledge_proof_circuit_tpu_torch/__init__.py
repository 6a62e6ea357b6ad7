"""PyTorch and CUDA port of the AES-128 zero-knowledge prover.

The counterpart of `aes_zero_knowledge_proof_circuit_tpu` (the JAX package,
kept as the reference), with the same public surface:
`synthesize_keys(..., device=...)`, `encrypt`, `verify_encryption`,
`compute_ciphertext`, plus proof (de)serialization and the typed errors.
Field products, NTTs and MSMs run hand-written Hopper kernels (`csrc/`) on
CUDA tensors and their plain PyTorch versions on CPU tensors. No module of
this package imports jax.
"""

from __future__ import annotations

__version__ = "0.1.0"

_API_SYMBOLS = (
    "synthesize_keys", "encrypt", "encrypt_batch", "verify_encryption",
    "compute_ciphertext", "bits_lsb_first", "generate_rand",
    "serialize_proof", "deserialize_proof", "Fr", "ZkAesError",
    "SynthesisError", "InvalidInputError", "CapacityError",
    "SerializationError", "ProofError", "Mesh", "make_mesh",
)

__all__ = list(_API_SYMBOLS) + ["api", "__version__"]


def __getattr__(name: str):
    if name in _API_SYMBOLS or name == "api":
        import importlib

        _api = importlib.import_module(".api", __name__)
        return _api if name == "api" else getattr(_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
