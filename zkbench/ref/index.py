"""The Marlin verifying key, worked out by the reference for itself.

The program generates its SRS from the configuration's seed: tau, then
gamma, each `randrange(1, r)` of `random.Random(seed)`. The reference
draws the same two numbers, and with tau in hand a KZG commitment to a
polynomial p is p(tau) * G, a single scalar multiple. So the nine index
commitments (row, col and val of A, B and C) come from the circuit alone:
each index polynomial is given by its values on its domain K, and its
value at tau is the barycentric sum over K. Which slots, values and
domains: the port's indexer's rules (`var_slots`, `required_degree`, the
COO order of each row), copied here.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .field import G, Point, R_MOD, mul, root_of_unity


@dataclass
class RefKey:
    log_n: int
    log_x: int
    num_instance: int
    log_ks: List[int]
    max_degree: int
    index_comms: List[Point]
    tau: int
    gamma_g: Point

    def to_json(self) -> dict:
        return dict(log_n=self.log_n, log_x=self.log_x,
                    num_instance=self.num_instance, log_ks=self.log_ks,
                    max_degree=self.max_degree,
                    index_comms=[None if p is None else [hex(p[0]), hex(p[1])]
                                 for p in self.index_comms])

    @classmethod
    def from_json(cls, d: dict, srs_seed: int) -> "RefKey":
        tau, gamma = srs_secrets(srs_seed)
        return cls(d["log_n"], d["log_x"], d["num_instance"], d["log_ks"],
                   d["max_degree"],
                   [None if p is None else (int(p[0], 16), int(p[1], 16))
                    for p in d["index_comms"]], tau, mul(G, gamma))


def srs_secrets(srs_seed: int):
    """(tau, gamma), drawn as the program's SRS generation draws them."""
    rng = random.Random(srs_seed)
    tau = rng.randrange(1, R_MOD)
    gamma = rng.randrange(1, R_MOD)
    return tau, gamma


def next_pow2_log(x: int) -> int:
    return max(1, (max(1, x) - 1).bit_length())


def required_degree(num_constraints: int, num_variables: int,
                    num_non_zero: int) -> int:
    n = 1 << next_pow2_log(max(num_constraints, num_variables))
    k = 1 << next_pow2_log(num_non_zero)
    return max(2 * n + 2, 2 * k)


def var_slots(r1cs):
    """(log_x, log_n, var_to_slot): instance variable j at H[j n / |X|],
    the witness variables in the other slots, in order."""
    log_x = next_pow2_log(r1cs.num_instance)
    x_size = 1 << log_x
    log_n = next_pow2_log(max(r1cs.num_constraints, r1cs.num_variables))
    while (1 << log_n) - x_size < r1cs.num_witness or (1 << log_n) < x_size:
        log_n += 1
    n = 1 << log_n
    stride = n // x_size
    slots = np.zeros(r1cs.num_variables, np.int64)
    slots[:r1cs.num_instance] = np.arange(r1cs.num_instance) * stride
    free = np.ones(n, bool)
    free[::stride] = False
    slots[r1cs.num_instance:] = np.nonzero(free)[0][:r1cs.num_witness]
    return log_x, log_n, slots.tolist()


def matrix_entries(rows):
    """(row, column, value) of one matrix, each row's entries by column."""
    out = []
    for i, row in enumerate(rows):
        for c, v in sorted(row.items()):
            out.append((i, c, v % R_MOD))
    return out


def lagrange_at(log_k: int, tau: int) -> List[int]:
    """L_j(tau) for each j of K = <w_k>, the Lagrange basis at tau:
    L_j(tau) = (tau^k - 1) / k * w^j / (tau - w^j)."""
    k = 1 << log_k
    w = root_of_unity(log_k)
    pw = [1] * k
    for j in range(1, k):
        pw[j] = pw[j - 1] * w % R_MOD
    d = [(tau - p) % R_MOD for p in pw]
    if 0 in d:
        raise ValueError("tau lies in K")
    prefix = [1] * k
    acc = 1
    for j in range(k):
        prefix[j] = acc
        acc = acc * d[j] % R_MOD
    inv = pow(acc, -1, R_MOD)
    scale = (pow(tau, k, R_MOD) - 1) * pow(k, -1, R_MOD) % R_MOD
    weights = [0] * k
    for j in range(k - 1, -1, -1):
        weights[j] = inv * prefix[j] % R_MOD * pw[j] % R_MOD * scale % R_MOD
        inv = inv * d[j] % R_MOD
    return weights


def at_tau(columns, log_k: int, tau: int,
           weights: Optional[List[int]] = None) -> List[int]:
    """p(tau) for each column of values of a polynomial p on K = <w_k>,
    the barycentric sum of its values against `lagrange_at(log_k, tau)`
    (given, where the caller keeps them)."""
    if weights is None:
        weights = lagrange_at(log_k, tau)
    return [sum(e * wt for e, wt in zip(col, weights)) % R_MOD
            for col in columns]


def derive_key(r1cs, srs_seed: int) -> RefKey:
    """The verifying key of a finalized R1CS under the seed's SRS."""
    tau, gamma = srs_secrets(srs_seed)
    log_x, log_n, var_to_slot = var_slots(r1cs)
    n = 1 << log_n
    h_w = root_of_unity(log_n)
    h_pows = [1] * n
    for i in range(1, n):
        h_pows[i] = h_pows[i - 1] * h_w % R_MOD
    n_inv = pow(n, -1, R_MOD)
    comms, log_ks = [], []
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        entries = matrix_entries(rows)
        log_k = next_pow2_log(len(entries))
        pad = (1 << log_k) - len(entries)
        row_e = [h_pows[r] for r, _c, _v in entries] + [1] * pad
        col_e = [h_pows[var_to_slot[c]] for _r, c, _v in entries] + [1] * pad
        val_e = [v * h_pows[var_to_slot[c]] % R_MOD * n_inv % R_MOD
                 for _r, c, v in entries] + [0] * pad
        for value in at_tau((row_e, col_e, val_e), log_k, tau):
            comms.append(mul(G, value))
        log_ks.append(log_k)
    nnz = max(sum(len(r) for r in rows)
              for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows))
    # the SRS is sized by the rule, and the key takes the SRS's degree
    max_degree = required_degree(r1cs.num_constraints, r1cs.num_variables,
                                 nnz)
    if max_degree < max(2 * n + 2, 2 * (1 << max(log_ks))):
        raise ValueError("the SRS sizing rule leaves the index no room")
    return RefKey(log_n, log_x, r1cs.num_instance, log_ks, max_degree,
                  comms, tau, mul(G, gamma))
