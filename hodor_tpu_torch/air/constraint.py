"""Constraint system data model.

Direct semantic port of src/air/constraint.rs and the register/density
enums of src/air/mod.rs:17-57. Field elements are canonical Python ints
(the owning Field is supplied where arithmetic is needed); `Constraint`
supports the same `+= / -= / *=`-style composition via `+`/`-`/`*`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union


# ---- registers (src/air/mod.rs:17-23) ----

@dataclasses.dataclass(frozen=True)
class Register:
    kind: str  # "pc" | "register" | "constant" | "aux"
    index: int

    @staticmethod
    def ProgramCounter(i: int) -> "Register":
        return Register("pc", i)

    @staticmethod
    def Register(i: int) -> "Register":
        return Register("register", i)

    @staticmethod
    def Constant(i: int) -> "Register":
        return Register("constant", i)

    @staticmethod
    def Aux(i: int) -> "Register":
        return Register("aux", i)


# ---- step differences (src/air/constraint.rs:129-133) ----

@dataclasses.dataclass(frozen=True)
class StepDifference:
    """Either Steps(k) before routing, or Mask(omega^k) after ARP routing
    (src/arp/mappings.rs:6-56)."""

    kind: str  # "steps" | "mask"
    value: int  # step count, or canonical field int

    @staticmethod
    def Steps(k: int) -> "StepDifference":
        return StepDifference("steps", k)

    @staticmethod
    def Mask(m: int) -> "StepDifference":
        return StepDifference("mask", m)


# ---- densities (src/air/mod.rs:29-121) ----

@dataclasses.dataclass(frozen=True)
class DenseConstraint:
    """Applies at every row in [start_at, num_rows - span)."""

    start_at: int = 0
    span: int = 1

    def __post_init__(self):
        assert self.span >= 1, "Span >= 1"


@dataclasses.dataclass(frozen=True)
class RepeatedConstraint:
    start_at: int = 0
    span: int = 1
    interval: int = 2

    def __post_init__(self):
        assert self.interval not in (0, 1) and self.span >= 1


@dataclasses.dataclass(frozen=True)
class SparseConstraint:
    rows: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rows", tuple(self.rows))


ConstraintDensity = Union[DenseConstraint, RepeatedConstraint, SparseConstraint]


# ---- terms ----

@dataclasses.dataclass(frozen=True)
class UnivariateTerm:
    """coeff * (register value at t + steps_difference) ^ power
    (src/air/constraint.rs:117-127)."""

    coeff: int
    register: Register
    steps_difference: StepDifference
    power: int

    @staticmethod
    def from_register(register: Register) -> "UnivariateTerm":
        return UnivariateTerm(1, register, StepDifference.Steps(0), 1)

    def with_step_difference(self, steps: int) -> "UnivariateTerm":
        return dataclasses.replace(self, steps_difference=StepDifference.Steps(steps))

    def pow(self, power: int) -> "UnivariateTerm":
        return dataclasses.replace(self, power=self.power * power)

    def scaled(self, c: int) -> "UnivariateTerm":
        return dataclasses.replace(self, coeff=self.coeff * c)


@dataclasses.dataclass
class PolyvariateTerm:
    """coeff * prod(UnivariateTerm_i) (src/air/constraint.rs:150-156)."""

    coeff: int = 1
    terms: List[UnivariateTerm] = dataclasses.field(default_factory=list)
    total_degree: int = 0

    @staticmethod
    def from_scaled_term(coeff: int, term: UnivariateTerm) -> "PolyvariateTerm":
        # matches From<(F, UnivariateTerm)>: fold the term's coeff in
        return PolyvariateTerm(
            coeff=coeff * term.coeff,
            terms=[dataclasses.replace(term, coeff=1)],
            total_degree=term.power,
        )

    def mul_by_term(self, term: UnivariateTerm) -> "PolyvariateTerm":
        return PolyvariateTerm(
            coeff=self.coeff * term.coeff,
            terms=self.terms + [dataclasses.replace(term, coeff=1)],
            total_degree=self.total_degree + term.power,
        )

    def mul_by_scalar(self, c: int) -> "PolyvariateTerm":
        return dataclasses.replace(self, coeff=self.coeff * c)

    def __imul__(self, other):
        if isinstance(other, UnivariateTerm):
            return self.mul_by_term(other)
        if isinstance(other, PolyvariateTerm):
            return PolyvariateTerm(
                coeff=self.coeff * other.coeff,
                terms=self.terms + list(other.terms),
                total_degree=self.total_degree + other.total_degree,
            )
        return self.mul_by_scalar(int(other))

    def __mul__(self, other):
        out = PolyvariateTerm(self.coeff, list(self.terms), self.total_degree)
        out *= other
        return out


ConstraintTerm = Union[UnivariateTerm, PolyvariateTerm]


def term_degree(term: ConstraintTerm) -> int:
    return term.power if isinstance(term, UnivariateTerm) else term.total_degree


def negate_term(term: ConstraintTerm) -> ConstraintTerm:
    if isinstance(term, UnivariateTerm):
        return dataclasses.replace(term, coeff=-term.coeff)
    return dataclasses.replace(term, coeff=-term.coeff)


# ---- constraints (src/air/constraint.rs:20-26, 266-316) ----

@dataclasses.dataclass
class Constraint:
    constant_term: int = 0
    terms: List[ConstraintTerm] = dataclasses.field(default_factory=list)
    degree: int = 0
    density: ConstraintDensity = dataclasses.field(default_factory=DenseConstraint)

    def add_term(self, term: ConstraintTerm) -> None:
        d = term_degree(term)
        if self.degree < d:
            self.degree = d
        self.terms.append(term)

    def __iadd__(self, rhs):
        if isinstance(rhs, (UnivariateTerm, PolyvariateTerm)):
            self.add_term(rhs)
        else:
            self.constant_term += int(rhs)
        return self

    def __isub__(self, rhs):
        if isinstance(rhs, (UnivariateTerm, PolyvariateTerm)):
            self.add_term(negate_term(rhs))
        else:
            self.constant_term -= int(rhs)
        return self

    def describe(self) -> str:
        parts = [f"deg {self.degree}: 0 = {self.constant_term}"]
        for t in self.terms:
            if isinstance(t, UnivariateTerm):
                parts.append(f"+ {t.coeff}*(R_{t.register.index}(t+{t.steps_difference.value}))^{t.power}")
            else:
                prod = "*".join(
                    f"(R_{u.register.index}(t+{u.steps_difference.value}))^{u.power}" for u in t.terms
                )
                parts.append(f"+ {t.coeff}*{prod}")
        return " ".join(parts)


@dataclasses.dataclass
class BoundaryConstraint:
    """register value at a fixed row (src/air/constraint.rs:10-15)."""

    register: Register
    at_row: int
    value: Optional[int]
