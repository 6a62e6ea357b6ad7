"""The Plonk verifying key, worked out by the reference for itself.

The port preprocesses a Plonk circuit (`plonk/backend.py` `setup`) by
interpolating its eight columns on the domain H of size n (the selectors
qL, qR, qO, qM, qC and the permutation's sigma1, sigma2, sigma3) and
committing to each without hiding, over the SRS its API draws from the
configuration's seed (`api._srs_for`: tau, then gamma, as for Marlin).
With tau in hand a commitment to p is p(tau) G, and p(tau) is the
barycentric sum of p's values on H (`index.at_tau`). So the key comes
from the frozen circuit and the seed alone.

The key keeps the Lagrange basis at tau (`weights`, computed once per
key): the judge's mask check commits to a proof's unblinded wire columns
and grand product (`grand_product`) with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..field import G, Point, R_MOD, mul
from ..index import at_tau, lagrange_at, srs_secrets


@dataclass
class PlonkRefKey:
    log_n: int
    omega: int
    ks: Tuple[int, int, int]
    num_public: int
    comms: List[Point]          # qL, qR, qO, qM, qC, sigma1, sigma2, sigma3
    tau: int
    _weights: Optional[List[int]] = None

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def weights(self) -> List[int]:
        """L_j(tau) for each j of H."""
        if self._weights is None:
            self._weights = lagrange_at(self.log_n, self.tau)
        return self._weights

    def commit_column(self, values: Sequence[int]) -> Point:
        """The commitment without hiding to the polynomial of `values` on
        H: sum_j e_j L_j(tau) G."""
        return mul(G, sum(e * w for e, w in zip(values, self.weights) if e)
                   % R_MOD)

    def to_json(self) -> dict:
        return dict(log_n=self.log_n, omega=hex(self.omega),
                    ks=[hex(k) for k in self.ks], num_public=self.num_public,
                    comms=[None if p is None else [hex(p[0]), hex(p[1])]
                           for p in self.comms])

    @classmethod
    def from_json(cls, d: dict, srs_seed: int) -> "PlonkRefKey":
        tau, _gamma = srs_secrets(srs_seed)
        return cls(d["log_n"], int(d["omega"], 16),
                   tuple(int(k, 16) for k in d["ks"]), d["num_public"],
                   [None if p is None else (int(p[0], 16), int(p[1], 16))
                    for p in d["comms"]], tau)


def derive_key(data, srs_seed: int) -> PlonkRefKey:
    """The verifying key of a compiled Plonk circuit (`PlonkCircuitData`)
    under the seed's SRS."""
    tau, _gamma = srs_secrets(srs_seed)
    weights = lagrange_at(data.log_n, tau)
    values = at_tau(list(data.selector_evals) + list(data.s_sigma_evals),
                    data.log_n, tau, weights)
    return PlonkRefKey(data.log_n, data.omega, tuple(data.ks),
                       data.num_public, [mul(G, v) for v in values], tau,
                       weights)


def grand_product(wires: Sequence[Sequence[int]],
                  sigmas: Sequence[Sequence[int]], omega: int,
                  ks: Sequence[int], beta: int, gamma: int) -> List[int]:
    """The permutation's grand product z on H, unblinded: z_0 = 1 and
    z_{j+1} = z_j prod_c (w_c[j] + beta k_c omega^j + gamma)
                     / (w_c[j] + beta sigma_c[j] + gamma),
    the numerators and the denominators multiplied up apart and divided
    with one inversion."""
    n = len(wires[0])
    nums = [1] * n
    dens = [1] * n                  # each row's denominator
    num = den = x = 1
    for j in range(n - 1):
        bx = beta * x
        f = g = 1
        for w, k, s in zip(wires, ks, sigmas):
            f = f * (w[j] + k * bx + gamma) % R_MOD
            g = g * (w[j] + beta * s[j] + gamma) % R_MOD
        num, den = num * f % R_MOD, den * g % R_MOD
        nums[j + 1], dens[j] = num, g
        x = x * omega % R_MOD
    inv = pow(den, -1, R_MOD)       # over the denominators of rows < n - 1
    z = [0] * n
    for j in range(n - 1, 0, -1):
        z[j] = nums[j] * inv % R_MOD
        inv = inv * dens[j - 1] % R_MOD
    z[0] = 1
    return z
