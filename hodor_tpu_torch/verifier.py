"""Stand-alone verifier (reference: src/verifier/mod.rs).

All scalar host work on Python ints: replays the Fiat-Shamir transcript,
checks the oracle queries, simulates h1/h2 at the query points from the
claimed f(m*z)/g(z) values (:405-488), re-evaluates every constraint at
z including divisors and degree adjustments (:490-631), and runs the FRI
query verifier for h1 and h2.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .air.constraint import Constraint, UnivariateTerm
from .air.density import density_key, inverse_divisor_at
from .ali.instance import (
    MaskProperties,
    get_mask_from_boundary_constraint,
    get_masks_from_constraint,
)
from .arp import InstanceProperties, remap_constraint
from .domain import Domain, next_power_of_two
from .errors import DivisionByZeroError, UnsatisfiedError
from .field.field import Field
from .fri import NaiveFriIop
from .merkle.tree import verify_path
from .prover import InstanceProof
from .transcript import Blake2sTranscript, bytes_to_challenge_index


def _evaluate_univariate_on_f_at_z_m(field: Field, term: UnivariateTerm,
                                     witness: List[Dict[int, int]]) -> int:
    reg = term.register.index
    mask = term.steps_difference.value
    if mask not in witness[reg]:
        raise UnsatisfiedError(f"missing f(m*z) for register {reg} mask {mask}")
    v = field.pow(witness[reg][mask], term.power)
    return v * (term.coeff % field.p) % field.p


def _evaluate_constraint_on_f_at_z_m(field: Field, c: Constraint,
                                     witness: List[Dict[int, int]]) -> int:
    value = c.constant_term % field.p
    for t in c.terms:
        if isinstance(t, UnivariateTerm):
            value = (value + _evaluate_univariate_on_f_at_z_m(field, t, witness)) % field.p
        else:
            prod = 1
            for u in t.terms:
                prod = prod * _evaluate_univariate_on_f_at_z_m(field, u, witness) % field.p
            value = (value + prod * (t.coeff % field.p)) % field.p
    return value


class Verifier:
    def __init__(self, properties: InstanceProperties, lde_factor: int):
        """Re-derives masks/domains/batches from the instance
        (src/verifier/mod.rs:160-244). `properties` must be un-routed
        (steps differences in steps); it is cloned and routed here."""
        properties = properties.clone()
        self.field: Field = properties.field
        field = self.field
        num_rows_sup = next_power_of_two(properties.num_rows)
        self.column_domain = Domain.new_for_size(field, num_rows_sup)
        properties.constraints = [
            remap_constraint(c, self.column_domain) for c in properties.constraints
        ]
        self.instance = properties
        self.lde_factor = lde_factor

        masks: Dict[MaskProperties, None] = {}
        self.max_constraint_power = 0
        for c in properties.constraints:
            get_masks_from_constraint(masks, c)
            if c.degree > self.max_constraint_power:
                self.max_constraint_power = c.degree

        constraint_power = next_power_of_two(self.max_constraint_power)
        self.constraints_domain = Domain.new_for_size(
            field, constraint_power * num_rows_sup
        )

        self.batches: Dict[Tuple, List[Constraint]] = {}
        for c in properties.constraints:
            self.batches.setdefault(density_key(c.density), []).append(c)

        for bc in properties.boundary_constraints:
            get_mask_from_boundary_constraint(masks, bc)
        self.all_masks: List[MaskProperties] = list(masks.keys())

    def verify(self, proof: InstanceProof) -> bool:
        field = self.field
        p = field.p
        transcript = Blake2sTranscript(field)

        # replay transcript (src/verifier/mod.rs:271-313)
        for r in proof.f_iop_roots:
            transcript.commit_bytes(r)
        constraint_challenges = []
        for _key, batch in self.batches.items():
            for _c in batch:
                a = transcript.get_challenge()
                b = transcript.get_challenge()
                constraint_challenges.append((a, b))
        boundary_challenges = []
        for _ in self.instance.boundary_constraints:
            a = transcript.get_challenge()
            b = transcript.get_challenge()
            boundary_challenges.append((a, b))

        transcript.commit_bytes(proof.g_iop_root)
        z = transcript.get_challenge()
        h1_challenges = [transcript.get_challenge() for _ in self.all_masks]

        transcript.commit_bytes(proof.h1_iop_roots[-1])
        for el in proof.fri_proof_h1.final_coefficients:
            transcript.commit_field_element(el)
        transcript.commit_bytes(proof.h2_iop_roots[-1])
        for el in proof.fri_proof_h2.final_coefficients:
            transcript.commit_field_element(el)

        f_lde_size = self.column_domain.size * self.lde_factor
        g_lde_size = self.constraints_domain.size * self.lde_factor
        f_lde_domain = Domain.new_for_size(field, f_lde_size)
        g_lde_domain = Domain.new_for_size(field, g_lde_size)

        x_h1 = bytes_to_challenge_index(transcript.get_challenge_bytes(), f_lde_size, self.lde_factor)
        x_h2 = bytes_to_challenge_index(transcript.get_challenge_bytes(), g_lde_size, self.lde_factor)

        # f oracle queries (:326-344)
        if len(proof.f_queries) != self.instance.num_registers:
            raise UnsatisfiedError("wrong number of register queries")
        if len(proof.f_queries) != len(proof.f_iop_roots):
            raise UnsatisfiedError("queries and roots mismatch")
        f_ldes_at_x = []
        for query, root in zip(proof.f_queries, proof.f_iop_roots):
            if not verify_path(root, query.value, query.path, query.tree_index, field):
                return False
            if query.natural_index != x_h1:
                return False
            f_ldes_at_x.append(query.value)

        # simulate h1 (:348-355, :405-461)
        h_1_at_x = self._simulate_h1_from_f_at_z(
            h1_challenges, x_h1, f_lde_domain, f_ldes_at_x, proof.f_at_z_m, z
        )

        # g at z from claimed f(m*z) (:359-363, :490-631)
        g_at_z = self._calculate_g_at_z_from_f_at_z(
            constraint_challenges, boundary_challenges, proof, z
        )

        if not verify_path(proof.g_iop_root, proof.g_query.value, proof.g_query.path,
                           proof.g_query.tree_index, field):
            return False
        if proof.g_query.natural_index != x_h2:
            return False
        g_lde_at_x = proof.g_query.value

        # simulate h2 (:376-382, :463-488)
        x = field.pow(g_lde_domain.generator, x_h2)
        den = (x - z) % p
        if den == 0:
            raise DivisionByZeroError("x == z")
        h_2_at_x = (g_lde_at_x - g_at_z) * field.inv(den) % p

        # FRI checks (:385-399)
        if not NaiveFriIop.verify_proof(proof.fri_proof_h1, x_h1, h_1_at_x, field):
            return False
        return NaiveFriIop.verify_proof(proof.fri_proof_h2, x_h2, h_2_at_x, field)

    def _simulate_h1_from_f_at_z(self, mask_challenges, natural_x_index, f_lde_domain,
                                 f_ldes_at_x, f_at_z_m, z) -> int:
        field = self.field
        p = field.p
        x = field.pow(f_lde_domain.generator, natural_x_index)
        h = 0
        for m, f_at_z, alpha in zip(self.all_masks, f_at_z_m, mask_challenges):
            root = m.mask * z % p
            f_at_x = f_ldes_at_x[m.register_index]
            num = (f_at_x - f_at_z) % p
            den = (x - root) % p
            if den == 0:
                raise DivisionByZeroError("no inverse in h1 simulation")
            h = (h + num * field.inv(den) % p * alpha) % p
        return h

    def _calculate_g_at_z_from_f_at_z(self, constraint_challenges, boundary_challenges,
                                      proof: InstanceProof, z: int) -> int:
        field = self.field
        p = field.p
        g_at_z = 0
        witness: List[Dict[int, int]] = [dict() for _ in range(self.instance.num_registers)]
        for m, f_at_z in zip(self.all_masks, proof.f_at_z_m):
            witness[m.register_index][m.mask] = f_at_z

        ch_iter = iter(constraint_challenges)
        for key, batch in self.batches.items():
            inverse_divisor = inverse_divisor_at(
                field, z, self.column_domain, key, self.instance.num_rows
            )
            for c in batch:
                alpha, beta = next(ch_iter)
                value_at_z = _evaluate_constraint_on_f_at_z_m(field, c, witness)
                adjustment = self.max_constraint_power - c.degree
                if adjustment == 0:
                    value_at_z = value_at_z * alpha % p
                else:
                    adj = (field.pow(z, adjustment) * alpha + beta) % p
                    value_at_z = value_at_z * adj % p
                g_at_z = (g_at_z + value_at_z * inverse_divisor) % p

        b_iter = iter(boundary_challenges)
        for bc in self.instance.boundary_constraints:
            alpha, beta = next(b_iter)
            adjustment = self.max_constraint_power - 1
            if 1 not in witness[bc.register.index]:
                raise UnsatisfiedError("missing unmasked value for boundary constraint")
            value_at_z = (witness[bc.register.index][1] - bc.value) % p
            root = field.pow(self.column_domain.generator, bc.at_row)
            den = (z - root) % p
            if den == 0:
                raise DivisionByZeroError("z equals boundary root")
            if adjustment == 0:
                value_at_z = value_at_z * alpha % p
            else:
                adj = (field.pow(z, adjustment) * alpha + beta) % p
                value_at_z = value_at_z * adj % p
            g_at_z = (g_at_z + value_at_z * field.inv(den)) % p

        return g_at_z
