"""Cubic VDF workload (reference: src/experiments/cubic_vdf.rs:13-265).

A cubing chain in Fp2 = F[x]/(x^2 - r) with r = -1, proven via an
intermediate squaring step: 4 registers (c0, c1, sq_c0, sq_c1) and 4
dense degree-2 constraints:

    sq_c0 = c0^2 + r*c1^2
    sq_c1 = 2*c0*c1
    c0'   = c0*sq_c0 + r*c1*sq_c1
    c1'   = c0*sq_c1 + c1*sq_c0

The witness chain runs on the host as a loop on Python ints or as the
native 4 x u64 Montgomery chain (utils/native.py), as for models/vdf.py.
"""

from __future__ import annotations

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
from ..utils.native import cubic_vdf_witness_native, u64_rows_to_ints
from .vdf import use_native_witness


class CubicVDF:
    def __init__(self, field: Field, start_c0: int, start_c1: int, num_operations: int,
                 witness: str = "auto"):
        """witness: "python", "native" or "auto", as for VDF."""
        self.field = field
        self.start_c0 = start_c0 % field.p
        self.start_c1 = start_c1 % field.p
        self.num_operations = num_operations
        self.native = use_native_witness(witness, num_operations)

    def into_arp(self) -> Tuple[Union[List[List[int]], np.ndarray], InstanceProperties]:
        field = self.field
        r = field.p - 1  # non-residue -1

        c0_reg = Register.Register(0)
        c1_reg = Register.Register(1)
        sq0_reg = Register.Register(2)
        sq1_reg = Register.Register(3)

        def now(reg, power=1, coeff=1):
            return UnivariateTerm(coeff, reg, StepDifference.Steps(0), power)

        def nxt(reg):
            return UnivariateTerm(1, reg, StepDifference.Steps(1), 1)

        def product(coeff, a, b):
            return PolyvariateTerm(coeff=coeff, terms=[now(a), now(b)], total_degree=2)

        # sq_c0 = c0^2 + r*c1^2
        sq0_c = Constraint(density=DenseConstraint())
        sq0_c -= now(c0_reg, power=2)
        sq0_c -= now(c1_reg, power=2, coeff=r)
        sq0_c += now(sq0_reg)

        # sq_c1 = 2*c0*c1
        sq1_c = Constraint(density=DenseConstraint())
        sq1_c -= product(2, c0_reg, c1_reg)
        sq1_c += now(sq1_reg)

        # c0' = c0*sq_c0 + r*c1*sq_c1
        c0_c = Constraint(density=DenseConstraint())
        c0_c -= product(1, c0_reg, sq0_reg)
        c0_c -= product(r, c1_reg, sq1_reg)
        c0_c += nxt(c0_reg)

        # c1' = c0*sq_c1 + c1*sq_c0
        c1_c = Constraint(density=DenseConstraint())
        c1_c -= product(1, c0_reg, sq1_reg)
        c1_c -= product(1, c1_reg, sq0_reg)
        c1_c += nxt(c1_reg)

        witness, final_c0, final_c1 = self._witness()

        boundary = [
            BoundaryConstraint(c0_reg, 0, self.start_c0),
            BoundaryConstraint(c1_reg, 0, self.start_c1),
            BoundaryConstraint(c0_reg, self.num_operations, final_c0),
            BoundaryConstraint(c1_reg, self.num_operations, final_c1),
        ]

        props = InstanceProperties(
            num_rows=self.num_operations + 1,
            num_registers=4,
            constraints=[sq0_c, sq1_c, c0_c, c1_c],
            boundary_constraints=boundary,
            field=field,
        )
        return witness, props

    def _witness(self):
        """Returns (witness, final_c0, final_c1): per row the element
        (c0, c1) and its square, the next row being element * square.
        witness is a List[List[int]] of canonical ints or, from the native
        chain, a (4, rows, 4) uint64 array of little-endian words."""
        if self.native:
            regs = cubic_vdf_witness_native(self.field, self.start_c0, self.start_c1,
                                            self.num_operations)
            (final_c0,), (final_c1,) = (u64_rows_to_ints(regs[0][-1:]),
                                        u64_rows_to_ints(regs[1][-1:]))
            return np.stack(regs), final_c0, final_c1
        p = self.field.p
        r = p - 1
        num_values = self.num_operations + 1
        c0_w = [0] * num_values
        c1_w = [0] * num_values
        sq0_w = [0] * num_values
        sq1_w = [0] * num_values
        v0, v1 = self.start_c0, self.start_c1
        for i in range(num_values):
            s0, s1 = (v0 * v0 + r * v1 * v1) % p, 2 * v0 * v1 % p
            c0_w[i], c1_w[i], sq0_w[i], sq1_w[i] = v0, v1, s0, s1
            v0, v1 = (s0 * v0 + r * s1 * v1) % p, (s0 * v1 + s1 * v0) % p
        return [c0_w, c1_w, sq0_w, sq1_w], c0_w[-1], c1_w[-1]
