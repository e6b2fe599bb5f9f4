"""AIR constraint DSL (reference: src/air/mod.rs, src/air/constraint.rs).

Registers, step differences / masks, constraint densities
(Dense / Repeated / Sparse), univariate & polyvariate terms and the
operator-overloaded `Constraint` builder, plus the `TraceSystem`
abstraction with the reference `TestTraceSystem` implementation and the
Fibonacci example gadget (src/air/test_trace_system.rs).

Field coefficients are canonical Python ints; everything here is pure
host-side description - the ARP/ALI layers compile it to batched device
evaluation.
"""

from .constraint import (
    BoundaryConstraint,
    Constraint,
    ConstraintDensity,
    DenseConstraint,
    PolyvariateTerm,
    Register,
    RepeatedConstraint,
    SparseConstraint,
    StepDifference,
    UnivariateTerm,
)
from .trace_system import Fibonacci, TestTraceSystem, TraceSystem, IntoAIR

__all__ = [
    "BoundaryConstraint",
    "Constraint",
    "ConstraintDensity",
    "DenseConstraint",
    "PolyvariateTerm",
    "Register",
    "RepeatedConstraint",
    "SparseConstraint",
    "StepDifference",
    "UnivariateTerm",
    "Fibonacci",
    "TestTraceSystem",
    "TraceSystem",
    "IntoAIR",
]
