"""The errors the frozen Plonk circuit copies raise (`plonk/circuit.py`,
`plonk/aes_map.py`), under the port's names, so that the copies keep the
port's lines but for their imports."""

from __future__ import annotations


class ZkAesError(Exception):
    """A circuit or witness the builder refuses."""


class InvalidInputError(ZkAesError, ValueError):
    """A message, key or ciphertext of the wrong length."""


def require(cond: bool, exc_type: type, msg: str) -> None:
    if not cond:
        raise exc_type(msg)
