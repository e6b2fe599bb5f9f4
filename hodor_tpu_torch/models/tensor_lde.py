"""Tensor-decomposed LDE queries (reference: src/experiments/tensor_lde.rs).

A test-only exploration in the reference: evaluate individual entries of
matrices/vectors given as Kronecker (tensor) products without
materializing them - the building block for query-only LDE access.
Host-scalar port with the same query semantics:

- matrix (x) identity : block-diagonal replication (:3-25)
- matrix (x) diagonal : per-block diagonal scaling (:27-57)
- vector (x) vector   : v[idx] = a[idx mod |a|] * b[idx div |a|] (:59-82)
- decompose_lde_generator_for_vector_over_vector: split the LDE
  evaluation geometry (omega powers over a coset) into two generator
  pairs so each tensor factor is a geometric progression (:84+)

A copy of hodor_tpu/models/tensor_lde.py for the port, which imports
nothing of that package.
"""

from __future__ import annotations

from typing import List, Tuple

from ..field.field import Field


def query_matrix_over_identity(
    field: Field, submatrix: Tuple[List[int], Tuple[int, int]], idx: Tuple[int, int]
) -> int:
    vals, (rows, cols) = submatrix
    if idx[0] // rows != idx[1] // cols:
        return 0
    return vals[cols * (idx[0] % rows) + (idx[1] % cols)]


def query_matrix_over_diagonal(
    field: Field,
    submatrix: Tuple[List[int], Tuple[int, int]],
    diagonal: Tuple[List[int], int],
    idx: Tuple[int, int],
) -> int:
    vals, (rows, cols) = submatrix
    if idx[0] // rows != idx[1] // cols:
        return 0
    d = diagonal[0][idx[0] // rows]
    return vals[cols * (idx[0] % rows) + (idx[1] % cols)] * d % field.p


def query_vector_over_vector(
    field: Field,
    subvector_1: Tuple[List[int], int],
    subvector_2: Tuple[List[int], int],
    idx: int,
) -> int:
    v1, n1 = subvector_1
    v2, n2 = subvector_2
    i0 = idx % n1
    i1 = idx // n1
    assert i1 < n2
    return v1[i0] * v2[i1] % field.p


def decompose_lde_generator_for_vector_over_vector(
    field: Field,
    lde_factor: int,
    domain_size: int,
    decomposition: Tuple[int, int],
    omega: int,
    coset_generator: int,
):
    """Split the geometric progression (g * w^i)_{i < N} into two tensor
    factors of sizes (n1, n2), n1*n2 = N: factor1 ratio w, start g;
    factor2 ratio w^n1, start 1 - so that
    (g*w^idx) = factor1[idx mod n1] * factor2[idx div n1].
    Returns ((start1, ratio1, n1), (start2, ratio2, n2))."""
    n1, n2 = decomposition
    assert n1 * n2 == domain_size * lde_factor
    return (
        (coset_generator, omega, n1),
        (1, field.pow(omega, n1), n2),
    )


def materialize_factor(field: Field, factor: Tuple[int, int, int]) -> Tuple[List[int], int]:
    start, ratio, n = factor
    out = []
    cur = start % field.p
    for _ in range(n):
        out.append(cur)
        cur = cur * ratio % field.p
    return out, n
