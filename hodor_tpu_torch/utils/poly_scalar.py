"""Scalar polynomial helpers (reference: src/utils/poly.rs).

O(n^2) Lagrange interpolation (:100-162, used by the reference only from
the dead deep_ali module but part of the utility surface) and
`evaluate_at_consequitive_powers` (:49-98) - host Python-int versions
for tests and the verifier. A copy of hodor_tpu/utils/poly_scalar.py for
the port, which imports nothing of that package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.field import Field


def evaluate_at_consecutive_powers(field: Field, coeffs: Sequence[int], base: int,
                                   first_power: int = 1) -> int:
    """sum_i coeffs[i] * base^(first_power + i)."""
    p = field.p
    acc = 0
    x = pow(base, first_power, p)
    for c in coeffs:
        acc = (acc + c * x) % p
        x = x * base % p
    return acc


def interpolate(field: Field, points: Sequence[Tuple[int, int]]) -> List[int]:
    """Lagrange interpolation through (x_i, y_i) -> coefficient list."""
    p = field.p
    n = len(points)
    coeffs = [0] * n
    for i, (xi, yi) in enumerate(points):
        # numerator polynomial prod_{j != i} (X - x_j)
        num = [1]
        denom = 1
        for j, (xj, _) in enumerate(points):
            if j == i:
                continue
            new = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                new[k] = (new[k] - c * xj) % p
                new[k + 1] = (new[k + 1] + c) % p
            num = new
            denom = denom * (xi - xj) % p
        scale = yi * pow(denom, -1, p) % p
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + c * scale) % p
    return coeffs


def evaluate(field: Field, coeffs: Sequence[int], x: int) -> int:
    """Horner evaluation."""
    p = field.p
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc
