"""ARP: trace columns -> witness polynomials over a 2^k subgroup.

Reference: src/arp/mod.rs (IntoARP / InstanceProperties / ARP trait),
src/arp/per_register/mod.rs (per-register instance: route() remaps
Steps(k) -> Mask(omega^k), make_witness_polymonials runs one inverse FFT
per register, verify_witness brute-force checks constraints),
src/arp/mappings.rs (the remap itself), src/arp/density_query.rs
(dense row iterator: rows [start_at, num_rows - span)).

The R register columns are stacked into an (R, T, L) limb tensor and
transformed with one batched iNTT over the row axis - the reference's
per-register thread fan-out (per_register/mod.rs:32-49) becomes a batch
dimension. The satisfiability check evaluates every constraint over all
rows as tensor ops on the device of the given LimbOps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np
import torch

from .air.constraint import (
    BoundaryConstraint,
    Constraint,
    DenseConstraint,
    StepDifference,
    UnivariateTerm,
)
from .domain import Domain, next_power_of_two
from .errors import SynthesisError, TracingError, UnsatisfiedError
from .field.field import Field
from .field.limbs import LimbOps, is_u64_rows
from .ntt import intt
from .profiling import span
from .utils.native import u64_rows_to_ints


@dataclasses.dataclass
class InstanceProperties:
    """Reference InstanceProperties (src/arp/mod.rs:78-84) + the field."""

    num_rows: int
    num_registers: int
    constraints: List[Constraint]
    boundary_constraints: List[BoundaryConstraint]
    field: Field

    def clone(self) -> "InstanceProperties":
        import copy

        return copy.deepcopy(self)


def remap_univariate_term(term: UnivariateTerm, column_domain: Domain) -> UnivariateTerm:
    """Steps(k) -> Mask(omega^k) (src/arp/mappings.rs:6-24)."""
    if term.steps_difference.kind != "steps":
        raise SynthesisError("step differences are not masks yet")
    mask = column_domain.field.pow(column_domain.generator, term.steps_difference.value)
    return dataclasses.replace(term, steps_difference=StepDifference.Mask(mask))


def remap_constraint(c: Constraint, column_domain: Domain) -> Constraint:
    new_terms = []
    for t in c.terms:
        if isinstance(t, UnivariateTerm):
            new_terms.append(remap_univariate_term(t, column_domain))
        else:
            new_terms.append(
                dataclasses.replace(
                    t, terms=[remap_univariate_term(u, column_domain) for u in t.terms]
                )
            )
    return dataclasses.replace(c, terms=new_terms)


# a witness as the models hand it over: columns of canonical ints, or the
# packed (R, rows, 4) uint64 array of the native chains
Witness = Union[List[List[int]], np.ndarray]


class ARPInstance:
    """Per-register ARP (reference ARPInstance<F, PerRegisterARP>) on the
    device of `ops`."""

    def __init__(self, properties: InstanceProperties, ops: LimbOps):
        self.properties = properties
        self.ops = ops

    @staticmethod
    def from_instance(properties: InstanceProperties, ops: LimbOps) -> "ARPInstance":
        inst = ARPInstance(properties, ops)
        inst.route()
        return inst

    def route(self) -> None:
        """Remap all constraint step differences into masks
        (src/arp/per_register/mod.rs:117-133)."""
        num_rows_sup = next_power_of_two(self.properties.num_rows)
        column_domain = Domain.new_for_size(self.properties.field, num_rows_sup)
        self.properties.constraints = [
            remap_constraint(c, column_domain) for c in self.properties.constraints
        ]

    def calculate_witness_polys(self, witness_device):
        """witness_device: (R, T, L) Montgomery limbs of trace values, or
        (B, R, T, L) for a batch of proofs -> the coefficient forms of the
        same shape (batched iNTT; reference make_witness_polymonials,
        src/arp/per_register/mod.rs:13-68)."""
        r, t = witness_device.shape[-3:-1]
        if r != self.properties.num_registers:
            raise SynthesisError("register count mismatch")
        if t != next_power_of_two(self.properties.num_rows):
            raise SynthesisError("row count mismatch")
        with span("witness_polys"):
            return intt(self.ops, witness_device)

    def encode_witness(self, witness: Witness):
        """Host witness columns -> padded (R, T, L) Montgomery tensor on
        the device. Takes List[List[int]] (canonical ints) or the native
        witness chains' (R, rows, 4) uint64 array of canonical
        little-endian words (utils/native.py), which skips the packing of
        Python ints: one copy to the device and one to-Montgomery mul."""
        t_sup = next_power_of_two(self.properties.num_rows)
        with span("encode_witness"):
            if is_u64_rows(witness):
                return self.ops.encode_u64_rows(witness, pad_rows=t_sup)
            padded = [list(col) + [0] * (t_sup - len(col)) for col in witness]
            return self.ops.encode(padded)

    # ---- satisfiability (reference verify_witness,
    #      src/arp/per_register/mod.rs:135-265) ----

    @staticmethod
    def is_satisfied(
        properties: InstanceProperties, witness: Witness, ops: LimbOps
    ) -> None:
        """Raises UnsatisfiedError if some constraint fails. Constraints
        here are PRE-ROUTING (steps differences still in steps). Evaluated
        as tensor ops over all rows of each constraint's density. Takes
        both witness forms of `encode_witness`."""
        field = properties.field
        packed = is_u64_rows(witness)
        num_rows = witness.shape[1] if packed else len(witness[0])
        if packed:
            w = ops.encode_u64_rows(witness)  # (R, T, L)
        else:
            w = ops.encode([list(c) for c in witness])

        from .air.density import density_active_rows, density_key

        for ci, c in enumerate(properties.constraints):
            if isinstance(c.density, DenseConstraint):
                start, span = c.density.start_at, c.density.span
                limit = num_rows - span
                if limit <= start:
                    continue
                rows = torch.arange(start, limit, device=ops.device)
                active = list(range(start, limit))
            else:
                # repeated/sparse (beyond the reference's DensityQuery,
                # src/arp/density_query.rs): the active rows
                active = density_active_rows(density_key(c.density), num_rows)
                if not active:
                    continue
                max_delta = max(
                    (u.steps_difference.value
                     for t in c.terms
                     for u in ([t] if isinstance(t, UnivariateTerm) else t.terms)),
                    default=0,
                )
                if max(active) + max_delta >= num_rows:
                    raise TracingError(
                        f"constraint {ci} density references row "
                        f"{max(active) + max_delta} beyond the trace"
                    )
                rows = torch.tensor(active, dtype=torch.int64, device=ops.device)
            vals = _eval_constraint_at_rows(ops, c, w, rows)
            nz = torch.nonzero(~ops.is_zero(vals)).flatten().cpu()
            if nz.numel():
                bad = active[int(nz[0])]
                raise UnsatisfiedError(
                    f"constraint {ci} ({c.describe()}) unsatisfied at row {bad}"
                )

        for bc in properties.boundary_constraints:
            # bounds are validated BEFORE indexing (the reference's
            # TracingError cases, src/air/mod.rs:125-145)
            if bc.register.index >= len(witness):
                raise TracingError(
                    f"boundary constraint register {bc.register.index} out of range"
                )
            if bc.at_row >= num_rows:
                raise TracingError(
                    f"boundary constraint row {bc.at_row} out of range"
                )
            if bc.value is not None:
                got = witness[bc.register.index][bc.at_row]
                if packed:
                    (got,) = u64_rows_to_ints(got)
                if got % field.p != bc.value % field.p:
                    raise UnsatisfiedError(
                        f"boundary constraint at row {bc.at_row} unsatisfied"
                    )


def _eval_univariate_at_rows(ops: LimbOps, term: UnivariateTerm, w, rows):
    assert term.steps_difference.kind == "steps"
    seg = w[term.register.index][rows + term.steps_difference.value]
    v = ops.pow_static(seg, term.power)
    return ops.mul(v, ops.const(term.coeff % ops.field.p))


def _eval_constraint_at_rows(ops: LimbOps, c: Constraint, w, rows):
    """Constraint values at a row index tensor."""
    acc = ops.const(c.constant_term % ops.field.p).expand(rows.shape[0], ops.n16)
    for t in c.terms:
        if isinstance(t, UnivariateTerm):
            acc = ops.add(acc, _eval_univariate_at_rows(ops, t, w, rows))
        else:
            prod = None
            for u in t.terms:
                v = _eval_univariate_at_rows(ops, u, w, rows)
                prod = v if prod is None else ops.mul(prod, v)
            prod = ops.mul(prod, ops.const(t.coeff % ops.field.p))
            acc = ops.add(acc, prod)
    return acc
