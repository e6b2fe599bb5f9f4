"""Poseidon hash chain workload: Starknet's Hades permutation over the
Stark prime, one round a row, permutation after permutation.

The permutation (starkware-libs/poseidon, parameter set `poseidon3`;
cairo-lang starkware/cairo/common/poseidon_utils.py `hades_permutation`):
width 3, S-box x^3 (a permutation, 3 does not divide p - 1), 4 full
rounds, 83 partial rounds (the S-box on the last element alone), 4 full
rounds; each round adds its constants, applies the S-box and multiplies
by the MDS matrix [[3, 1, 1], [1, -1, 1], [1, 1, -2]]. The chain starts
from (c0, c1, 2), as Starknet's poseidon_hash(x, y) does, and round 0 of
permutation n + 1 follows round 90 of permutation n.

Ten registers a row: x0..x2 (the state after the round's constants), a0..a2
(their cubes), k0..k2 (the round's constants) and f (1 in a full round).
Dense constraints over rows [0, rows - 1):

    cube_j: a_j - x_j^3 = 0                                     (degree 3)
    mix_i:  x_i' - k_i' - sum_j M_ij s_j = 0, s_j = f a_j + x_j - f x_j
            for j = 0, 1 and s_2 = a_2                          (degree 2)

and 6 boundary constraints, x_j at the first and the last row. The AIR
has no periodic columns, so k and f are committed trace columns that no
constraint binds to the constants.

The round constants follow one rule, not Starknet's published table:
RC[r][j] = int.from_bytes(blake2s(f"hodor-poseidon3-rc-{r}-{j}"), "little")
mod p. The witness runs on Python ints or on the native Montgomery chain
(utils/native.py), which long chains take by default and which hands the
prover a packed (10, rows, 4) uint64 array.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Tuple, Union

import numpy as np

from ..air.constraint import (
    BoundaryConstraint,
    Constraint,
    DenseConstraint,
    PolyvariateTerm,
    Register,
    StepDifference,
    UnivariateTerm,
)
from ..arp import InstanceProperties
from ..field.field import Field
from ..utils.native import poseidon_witness_native, u64_rows_to_ints
from .vdf import use_native_witness

WIDTH = 3
FULL_ROUNDS = 8  # half before the partial rounds, half after
PARTIAL_ROUNDS = 83
ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
MDS = ((3, 1, 1), (1, -1, 1), (1, 1, -2))
REGISTERS = 10
# register indices
X, A, K, F = (0, 1, 2), (3, 4, 5), (6, 7, 8), 9


@lru_cache(maxsize=4)
def round_constants(p: int) -> Tuple[Tuple[int, int, int], ...]:
    """RC[r][j] for the 91 rounds of the permutation."""
    return tuple(tuple(int.from_bytes(hashlib.blake2s(f"hodor-poseidon3-rc-{r}-{j}".encode())
                                      .digest(), "little") % p for j in range(WIDTH))
                 for r in range(ROUNDS))


def is_full_round(r: int) -> bool:
    return r < FULL_ROUNDS // 2 or r >= ROUNDS - FULL_ROUNDS // 2



class PoseidonChain:
    def __init__(self, field: Field, start_c0: int, start_c1: int, num_operations: int,
                 witness: str = "auto"):
        """num_operations rounds of the chain from (c0, c1, 2), so
        num_operations + 1 rows; witness: "python", "native" or "auto",
        as for VDF."""
        self.field = field
        self.start = (start_c0 % field.p, start_c1 % field.p, 2 % field.p)
        self.num_operations = num_operations
        self.native = use_native_witness(witness, num_operations)

    def into_arp(self) -> Tuple[Union[List[List[int]], np.ndarray], InstanceProperties]:
        regs = [Register.Register(i) for i in range(REGISTERS)]

        def term(reg, step=0, power=1, coeff=1):
            return UnivariateTerm(coeff, regs[reg], StepDifference.Steps(step), power)

        def product(coeff, a, b):
            return PolyvariateTerm(coeff=coeff, terms=[term(a), term(b)], total_degree=2)

        constraints = []
        for j in range(WIDTH):  # a_j = x_j^3
            c = Constraint(density=DenseConstraint())
            c += term(A[j])
            c -= term(X[j], power=3)
            constraints.append(c)
        for i in range(WIDTH):  # x_i' - k_i' = sum_j M_ij s_j
            c = Constraint(density=DenseConstraint())
            c += term(X[i], step=1)
            c -= term(K[i], step=1)
            for j in range(WIDTH - 1):
                m = MDS[i][j]
                c -= product(m, F, A[j])
                c -= term(X[j], coeff=m)
                c += product(m, F, X[j])
            c -= term(A[2], coeff=MDS[i][2])
            constraints.append(c)

        witness, first, last = self._witness()
        last_row = self.num_operations
        boundary = ([BoundaryConstraint(regs[X[j]], 0, first[j]) for j in range(WIDTH)]
                    + [BoundaryConstraint(regs[X[j]], last_row, last[j]) for j in range(WIDTH)])
        props = InstanceProperties(
            num_rows=self.num_operations + 1,
            num_registers=REGISTERS,
            constraints=constraints,
            boundary_constraints=boundary,
            field=self.field,
        )
        return witness, props

    def _witness(self):
        """Returns (witness, x of the first row, x of the last row): the
        witness a List[List[int]] of canonical ints or, from the native
        chain, a (10, rows, 4) uint64 array of little-endian words."""
        p = self.field.p
        rc = round_constants(p)
        if self.native:
            w = poseidon_witness_native(self.field, rc, self.start, self.num_operations)
            return (w, u64_rows_to_ints(w[list(X), 0]),
                    u64_rows_to_ints(w[list(X), self.num_operations]))
        cols = [[] for _ in range(REGISTERS)]
        s = list(self.start)
        for row in range(self.num_operations + 1):
            r = row % ROUNDS
            full = is_full_round(r)
            x = [(v + k) % p for v, k in zip(s, rc[r])]
            a = [v * v % p * v % p for v in x]
            for reg, v in zip(X + A + K + (F,), x + a + list(rc[r]) + [int(full)]):
                cols[reg].append(v)
            y = a if full else [x[0], x[1], a[2]]
            s = [sum(m * v for m, v in zip(row, y)) % p for row in MDS]
        return cols, [c[0] for c in cols[:WIDTH]], [c[-1] for c in cols[:WIDTH]]
