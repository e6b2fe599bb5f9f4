"""TraceSystem abstraction + TestTraceSystem + Fibonacci gadget.

Port of src/air/mod.rs:147-197 (TraceSystem / IntoAIR traits) and
src/air/test_trace_system.rs (the reference trace fixture that stores
per-register witness columns and witness-generator closures, runs them
step by step, and exports to ARP with register remapping).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..errors import TracingError
from ..field.field import Field
from .constraint import (
    BoundaryConstraint,
    Constraint,
    Register,
    StepDifference,
    UnivariateTerm,
)


class TraceSystem:
    """Interface (reference trait src/air/mod.rs:147-192)."""

    def allocate_register(self, name: str) -> Register:
        raise NotImplementedError

    def get_register(self, step: int, register: Register) -> int:
        raise NotImplementedError

    def allocate_constant_register(self, name: str, fn) -> Register:
        raise NotImplementedError

    def allocate_aux_register(self) -> Register:
        raise NotImplementedError

    def add_constraint(self, constraint: Constraint, fn) -> None:
        raise NotImplementedError

    def add_constraint_with_witness(self, constraint: Constraint, fn) -> None:
        raise NotImplementedError

    def add_boundary_constraint(
        self, name: str, register: Register, at_step: int, value: Optional[int]
    ) -> None:
        raise NotImplementedError

    def step(self, num_steps: int) -> None:
        raise NotImplementedError

    def get_step_number(self) -> int:
        raise NotImplementedError


class IntoAIR:
    """Workloads implement trace(tracer) (reference src/air/mod.rs:195-197)."""

    def trace(self, tracer: TraceSystem) -> None:
        raise NotImplementedError


class TestTraceSystem(TraceSystem):
    """Reference TraceSystem impl (src/air/test_trace_system.rs:17-155)."""

    def __init__(self, field: Field):
        self.field = field
        self.pc_registers: List[str] = []
        self.registers: List[str] = []
        self.constant_registers: List[str] = []
        self.aux_registers: List[str] = []
        self.pc_registers_witness: List[List[int]] = []
        self.registers_witness: List[List[int]] = []
        self.constant_registers_witness: List[List[int]] = []
        self.aux_registers_witness: List[List[int]] = []
        self.witness_generators: List[Callable] = []
        self.constraints: List[Constraint] = []
        self.boundary_constraints: List[BoundaryConstraint] = []
        self.current_step = 0

    def allocate_register(self, name: str) -> Register:
        n = len(self.registers)
        self.registers.append(name)
        self.registers_witness.append([])
        return Register.Register(n)

    def get_register(self, step: int, register: Register) -> int:
        if register.kind != "register":
            raise TracingError("only plain registers are readable")
        w = self.registers_witness[register.index]
        if step >= len(w):
            raise TracingError(f"no witness at step {step}")
        return w[step]

    def allocate_constant_register(self, name: str, fn) -> Register:
        n = len(self.constant_registers)
        self.constant_registers.append(name)
        self.constant_registers_witness.append([])
        return Register.Constant(n)

    def allocate_aux_register(self) -> Register:
        n = len(self.aux_registers)
        self.aux_registers.append(f"Aux({n})")
        self.aux_registers_witness.append([])
        return Register.Aux(n)

    def add_constraint(self, constraint: Constraint, fn) -> None:
        self.constraints.append(constraint)

    def add_constraint_with_witness(self, constraint: Constraint, fn) -> None:
        self.constraints.append(constraint)
        self.witness_generators.append(fn)

    def add_boundary_constraint(
        self, name: str, register: Register, at_step: int, value: Optional[int]
    ) -> None:
        self.boundary_constraints.append(
            BoundaryConstraint(register=register, at_row=at_step, value=value)
        )

    def step(self, num_steps: int) -> None:
        if num_steps == 0:
            raise TracingError("cannot step by 0")
        self.current_step += num_steps

    def get_step_number(self) -> int:
        return self.current_step

    def calculate_witness(self, a: int, b: int, steps: int) -> None:
        """Run witness generators step by step
        (src/air/test_trace_system.rs:268-298). Initial values follow the
        reference: both registers start at 1."""
        self.registers_witness[0].append(1 % self.field.p)
        self.registers_witness[1].append(1 % self.field.p)
        for _ in range(steps):
            for gen in self.witness_generators:
                for (value, register, step_delta) in gen(self):
                    assert register.kind == "register"
                    w = self.registers_witness[register.index]
                    at = self.current_step + step_delta
                    if len(w) <= at:
                        w.extend([0] * (at + 1 - len(w)))
                    w[at] = value % self.field.p
            self.current_step += 1

    def into_arp(self):
        """Flatten registers to uniform Register(i) indices and collect the
        witness (src/arp/mod.rs:87-246)."""
        from ..arp import InstanceProperties

        num_pc = len(self.pc_registers)
        num_reg = len(self.registers)
        num_aux = len(self.aux_registers)
        num_const = len(self.constant_registers)
        total = num_pc + num_reg + num_aux + num_const
        num_rows = self.current_step + 1

        reg_off = num_pc
        aux_off = reg_off + num_reg
        const_off = aux_off + num_aux

        def remap(r: Register) -> Register:
            if r.kind == "pc":
                return Register.Register(r.index)
            if r.kind == "register":
                return Register.Register(r.index + reg_off)
            if r.kind == "aux":
                return Register.Register(r.index + aux_off)
            return Register.Register(r.index + const_off)

        import dataclasses as dc

        def remap_term(t):
            from .constraint import UnivariateTerm, PolyvariateTerm

            if isinstance(t, UnivariateTerm):
                return dc.replace(t, register=remap(t.register))
            return dc.replace(t, terms=[dc.replace(u, register=remap(u.register)) for u in t.terms])

        constraints = []
        for c in self.constraints:
            constraints.append(
                dc.replace(c, terms=[remap_term(t) for t in c.terms])
            )
        boundary = [dc.replace(b, register=remap(b.register)) for b in self.boundary_constraints]

        witness = []
        for group in (
            self.pc_registers_witness,
            self.registers_witness,
            self.aux_registers_witness,
            self.constant_registers_witness,
        ):
            for col in group:
                if col:
                    witness.append(list(col))
        assert len(witness) == total

        props = InstanceProperties(
            num_rows=num_rows,
            num_registers=num_reg,
            constraints=constraints,
            boundary_constraints=boundary,
            field=self.field,
        )
        return (witness if witness else None), props


class Fibonacci(IntoAIR):
    """The reference Fibonacci AIR gadget
    (src/air/test_trace_system.rs:158-246)."""

    def __init__(self, field: Field, final_b: Optional[int] = None, at_step: Optional[int] = None):
        self.field = field
        self.final_b = final_b
        self.at_step = at_step

    def trace(self, tracer: TraceSystem) -> None:
        a_reg = tracer.allocate_register("A")
        b_reg = tracer.allocate_register("B")

        def witness_fn_0(ts):
            step = ts.get_step_number()
            value = ts.get_register(step, b_reg)
            return [(value, a_reg, 1)]

        def witness_fn_1(ts):
            step = ts.get_step_number()
            a = ts.get_register(step, a_reg)
            b = ts.get_register(step, b_reg)
            return [((a + b) % self.field.p, b_reg, 1)]

        a_now = UnivariateTerm(1, a_reg, StepDifference.Steps(0), 1)
        b_now = UnivariateTerm(1, b_reg, StepDifference.Steps(0), 1)
        a_next = UnivariateTerm(1, a_reg, StepDifference.Steps(1), 1)
        b_next = UnivariateTerm(1, b_reg, StepDifference.Steps(1), 1)

        c0 = Constraint()
        c0 -= b_now
        c0 += a_next
        c1 = Constraint()
        c1 -= a_now
        c1 -= b_now
        c1 += b_next

        tracer.add_constraint_with_witness(c0, witness_fn_0)
        tracer.add_constraint_with_witness(c1, witness_fn_1)

        if self.final_b is not None:
            tracer.add_boundary_constraint("Initial A", a_reg, 0, 1)
            tracer.add_boundary_constraint("Initial B", b_reg, 0, 1)
            tracer.add_boundary_constraint("Final B", b_reg, self.at_step, self.final_b)
