"""Quadratic VDF workload (reference: src/experiments/vdf.rs:12-131).

An Fp2 = F[x]/(x^2 - r) squaring chain with r = -1: squaring (c0, c1) is
(c0^2 + r*c1^2, 2*c0*c1); proven with 2 registers, 2 dense degree-2
constraints and 4 boundary constraints. The witness chain runs on the
host in one of two forms: a loop on Python ints, or the native 4 x u64
Montgomery chain (utils/native.py, compiled with g++ at first use), which
long chains take by default and which hands the prover a packed
(registers, rows, 4) uint64 array instead of lists of ints.
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
from ..utils.native import u64_rows_to_ints, vdf_witness_native

WITNESS_FORMS = ("auto", "python", "native")
# chains of at least this many operations take the native form under "auto"
_NATIVE_MIN_OPS = 1 << 12


def use_native_witness(witness: str, num_operations: int) -> bool:
    """Whether a model asked for `witness` runs the native chain: "native"
    always, "python" never, "auto" from _NATIVE_MIN_OPS operations on."""
    if witness not in WITNESS_FORMS:
        raise ValueError(f"witness must be one of {WITNESS_FORMS}, not {witness!r}")
    return witness == "native" or (witness == "auto" and num_operations >= _NATIVE_MIN_OPS)


class VDF:
    def __init__(self, field: Field, start_c0: int, start_c1: int, num_operations: int,
                 witness: str = "auto"):
        """witness: the form of the witness chain, "python" (ints),
        "native" (the compiled chain; raises without g++ or for a field
        over 256 bits) or "auto" (native for long chains)."""
        self.field = field
        self.start_c0 = start_c0 % field.p
        self.start_c1 = start_c1 % field.p
        self.num_operations = num_operations
        self.native = use_native_witness(witness, num_operations)

    def into_arp(self) -> Tuple[Union[List[List[int]], np.ndarray], InstanceProperties]:
        field = self.field
        p = field.p
        non_residue = p - 1  # -1

        c0_reg = Register.Register(0)
        c1_reg = Register.Register(1)

        c0_now = UnivariateTerm(1, c0_reg, StepDifference.Steps(0), 1)
        c1_now = UnivariateTerm(1, c1_reg, StepDifference.Steps(0), 1)
        c0_next = UnivariateTerm(1, c0_reg, StepDifference.Steps(1), 1)
        c1_next = UnivariateTerm(1, c1_reg, StepDifference.Steps(1), 1)

        c0_squared = c0_now.pow(2)
        c1_squared_by_r = c1_now.pow(2).scaled(non_residue)
        two_c0_c1 = PolyvariateTerm(coeff=2, terms=[
            UnivariateTerm(1, c0_reg, StepDifference.Steps(0), 1),
            UnivariateTerm(1, c1_reg, StepDifference.Steps(0), 1),
        ], total_degree=2)

        c0_constraint = Constraint(density=DenseConstraint())
        c0_constraint -= c0_squared
        c0_constraint -= c1_squared_by_r
        c0_constraint += c0_next

        c1_constraint = Constraint(density=DenseConstraint())
        c1_constraint -= two_c0_c1
        c1_constraint += c1_next

        num_values = self.num_operations + 1
        witness, final_c0, final_c1 = self._witness()

        boundary = [
            BoundaryConstraint(c0_reg, 0, self.start_c0),
            BoundaryConstraint(c1_reg, 0, self.start_c1),
            BoundaryConstraint(c0_reg, self.num_operations, final_c0),
            BoundaryConstraint(c1_reg, self.num_operations, final_c1),
        ]

        props = InstanceProperties(
            num_rows=num_values,
            num_registers=2,
            constraints=[c0_constraint, c1_constraint],
            boundary_constraints=boundary,
            field=field,
        )
        return witness, props

    def _witness(self):
        """Returns (witness, final_c0, final_c1): witness is a
        List[List[int]] of canonical ints (the Python squaring chain) or,
        from the native chain, a (2, rows, 4) uint64 array of canonical
        little-endian words; `ARPInstance.encode_witness` takes both."""
        if self.native:
            c0_w, c1_w = vdf_witness_native(self.field, self.start_c0, self.start_c1,
                                            self.num_operations)
            (final_c0,), (final_c1,) = u64_rows_to_ints(c0_w[-1:]), u64_rows_to_ints(c1_w[-1:])
            return np.stack([c0_w, c1_w]), final_c0, final_c1
        field = self.field
        p = field.p
        non_residue = p - 1
        num_values = self.num_operations + 1
        c0_w = [0] * num_values
        c1_w = [0] * num_values
        c0_w[0], c1_w[0] = self.start_c0, self.start_c1
        v0, v1 = self.start_c0, self.start_c1
        for i in range(self.num_operations):
            v0, v1 = (
                (v0 * v0 + non_residue * v1 * v1) % p,
                2 * v0 * v1 % p,
            )
            c0_w[i + 1], c1_w[i + 1] = v0, v1
        return [c0_w, c1_w], c0_w[-1], c1_w[-1]
