"""Typed error tier — the reference's error-glue layer.

The reference converts every `SynthesisError`/`Option` miss into a typed
`anyhow::Result` with a message (src/helpers/traits.rs:4-20) and the API
returns `Result<_>` everywhere (src/lib.rs:60,116,138). The TPU stack's
equivalent is this exception hierarchy: API misuse raises a specific
subclass of ``ZkAesError`` instead of a bare ``AssertionError``, so callers
can catch the family or a specific failure.
"""

from __future__ import annotations


class ZkAesError(Exception):
    """Base class for every error raised by the public API."""


class SynthesisError(ZkAesError):
    """Circuit/template construction failed (reference: ark-relations
    SynthesisError, converted at src/helpers/traits.rs:4-12)."""


class InvalidInputError(ZkAesError, ValueError):
    """API misuse: wrong message/key/IV length, non-multiple-of-16 message,
    missing IV for CBC (reference: anyhow bail!-style checks, e.g.
    benches/benchmark_encrypt.rs:34-37 length guard)."""


class CapacityError(ZkAesError):
    """Circuit exceeds SRS capacity (reference: generate_universal_srs
    bounds at src/lib.rs:141)."""


class SerializationError(ZkAesError):
    """Proof/key (de)serialization failed (reference: ark-serialize errors
    surfaced through deserialize_proof, src/lib.rs:52)."""


class ProofError(ZkAesError):
    """Proving failed internally (witness does not satisfy the template,
    domain overflow, ...)."""


def require(cond: bool, exc_type: type, msg: str) -> None:
    """`ToAnyhow`-style guard: raise ``exc_type(msg)`` when ``cond`` fails."""
    if not cond:
        raise exc_type(msg)
