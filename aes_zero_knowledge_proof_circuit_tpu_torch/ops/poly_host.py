"""Host-side radix-2 NTT domains and polynomial utilities over Fr.

Host oracle for ntt_jax.py (the TPU NTT kernel, SURVEY.md §7 step 4) and the
polynomial toolbox for the Marlin prover/indexer. Mirrors the role of
ark-poly's GeneralEvaluationDomain at the reference's call sites
(SURVEY.md §2b): radix-2 FFT/iFFT over BLS12-377 Fr (2-adicity 47).

All domains are the canonical 2-adic subgroups H_m = <w_m> with
w_m = w_47^(2^(47-m)), so smaller domains are always subgroups of larger
ones (used by the input-domain X ⊂ H embedding in marlin/indexer.py).

Polynomials are coefficient lists (low -> high) of Python ints mod r.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

from .field_params import R_MOD, inv_mod, root_of_unity


class Domain:
    """Multiplicative subgroup of Fr of size 2^log_n."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = root_of_unity(log_n) if log_n > 0 else 1
        self.omega_inv = inv_mod(self.omega, R_MOD)
        self.n_inv = inv_mod(self.n, R_MOD)

    @functools.cached_property
    def elements(self) -> List[int]:
        out = [1] * self.n
        for i in range(1, self.n):
            out[i] = out[i - 1] * self.omega % R_MOD
        return out

    def vanishing_eval(self, x: int) -> int:
        """v_H(x) = x^n - 1."""
        return (pow(x, self.n, R_MOD) - 1) % R_MOD

    # -- NTT ---------------------------------------------------------------

    def ntt(self, coeffs: Sequence[int]) -> List[int]:
        """Evaluate a polynomial (deg < n) on the domain, natural order."""
        assert len(coeffs) <= self.n
        a = list(coeffs) + [0] * (self.n - len(coeffs))
        return _ntt_in_place(a, self.omega)

    def intt(self, evals: Sequence[int]) -> List[int]:
        """Interpolate values on the domain back to coefficients."""
        assert len(evals) == self.n
        a = _ntt_in_place(list(evals), self.omega_inv)
        return [x * self.n_inv % R_MOD for x in a]


@functools.lru_cache(maxsize=None)
def domain(log_n: int) -> Domain:
    return Domain(log_n)


def domain_for_size(size: int) -> Domain:
    log_n = max(0, (size - 1).bit_length())
    return domain(log_n)


def _ntt_in_place(a: List[int], omega: int) -> List[int]:
    """Iterative decimation-in-time radix-2 NTT (natural in/out order)."""
    n = len(a)
    if n == 1:
        return a
    # bit-reverse permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R_MOD)
        half = length >> 1
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u = a[k]
                v = a[k + half] * w % R_MOD
                a[k] = (u + v) % R_MOD
                a[k + half] = (u - v) % R_MOD
                w = w * w_len % R_MOD
        length <<= 1
    return a


# ---------------------------------------------------------------------------
# Coefficient-space polynomial utilities
# ---------------------------------------------------------------------------


def poly_trim(p: Sequence[int]) -> List[int]:
    p = list(p)
    while p and p[-1] % R_MOD == 0:
        p.pop()
    return p


def poly_degree(p: Sequence[int]) -> int:
    t = poly_trim(p)
    return len(t) - 1 if t else -1


def poly_add(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R_MOD
            for i in range(n)]


def poly_sub(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % R_MOD
            for i in range(n)]


def poly_scale(a: Sequence[int], k: int) -> List[int]:
    return [x * k % R_MOD for x in a]


def poly_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Product via NTT on a domain of size >= deg(a)+deg(b)+1."""
    a, b = poly_trim(a), poly_trim(b)
    if not a or not b:
        return []
    out_len = len(a) + len(b) - 1
    d = domain_for_size(out_len)
    fa = d.ntt(a)
    fb = d.ntt(b)
    prod = [x * y % R_MOD for x, y in zip(fa, fb)]
    return poly_trim(d.intt(prod))[:out_len]


def poly_eval(p: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % R_MOD
    return acc


def poly_div_vanishing(p: Sequence[int], n: int) -> tuple[List[int], List[int]]:
    """Divide p by v = X^n - 1. Returns (quotient, remainder).

    Exact-shift method (vectorizable, used identically on TPU): with
    p = sum p_i X^i, the quotient is h_i = sum_{j>=1} p_{i + j n} and the
    remainder is r_i = p_i + h_i for i < n.
    """
    p = list(p)
    if len(p) <= n:
        return [], poly_trim(p)
    h_len = len(p) - n
    h = [0] * h_len
    # accumulate from the top so h_i = p_{n+i} + h_{n+i}
    for i in range(h_len - 1, -1, -1):
        acc = p[n + i]
        if i + n < h_len:
            acc += h[i + n]
        h[i] = acc % R_MOD
    rem = [(p[i] + (h[i] if i < h_len else 0)) % R_MOD for i in range(n)]
    return poly_trim(h), poly_trim(rem)


def poly_div_linear(p: Sequence[int], z: int) -> tuple[List[int], int]:
    """Divide p by (X - z): returns (quotient, p(z)). Synthetic division:
    q_{d-1} = p_d;  q_{i-1} = p_i + z q_i;  rem = p_0 + z q_0."""
    if not p:
        return [], 0
    q: List[int] = [0] * (len(p) - 1)
    carry = 0
    for i in range(len(p) - 1, 0, -1):
        carry = (p[i] + carry * z) % R_MOD
        q[i - 1] = carry
    rem = (p[0] + carry * z) % R_MOD
    return q, rem


def poly_random(degree: int, rng) -> List[int]:
    return [rng.randrange(R_MOD) for _ in range(degree + 1)]
