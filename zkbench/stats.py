"""Order statistics the harness and its tests share."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of every value, interpolated
    between order statistics (`statistics.quantiles`, inclusive); a single
    value is its own."""
    values = sorted(values)
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles
    (`statistics.quantiles(values, n=4)`, its default method) as a share
    of the median: how the bounds of BENCHMARK.json were set."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
