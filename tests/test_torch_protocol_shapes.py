"""The port off the goldens' ground, on CPU tensors: FRI to degree 4, lde
factor 8, dense densities with start_at / span, six registers with
polyvariate cross-register terms, and Repeated / Sparse densities.

Each instance is built twice from one description, with the port's AIR
classes and with hodor_tpu's. The port's proof bytes are held against
the scalar oracle (tests/scalar_oracle.py), whose constraint schema
covers dense densities and polyvariate terms, and, for Repeated / Sparse
(which the oracle does not have), against hodor_tpu's prover. Both
packages' verifiers accept the port's proof, the port's verifier accepts
the reference's bytes, and a proof of a tampered witness is rejected by
both. Tolerance 0: proof bytes and challenge logs are compared whole."""

import os
import sys
from functools import lru_cache

import pytest
import torch

import hodor_tpu.air as jair
import hodor_tpu.arp as jarp
import hodor_tpu.proof_io as jproof_io
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK
from hodor_tpu.prover import Prover as JProver
from hodor_tpu.verifier import Verifier as JVerifier
import hodor_tpu_torch.air as tair
import hodor_tpu_torch.arp as tarp
from hodor_tpu_torch.field import F257, F_STARK
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier

sys.path.insert(0, os.path.dirname(__file__))
import scalar_oracle as so  # noqa: E402

torch.set_num_threads(1)

# the port's package and field beside hodor_tpu's
PORT = (tair, tarp, {"F257": F257, "F_STARK": F_STARK})
JAX = (jair, jarp, {"F257": JF257, "F_STARK": JF_STARK})


# ------------------------------------------------------------ instances
# Each instance function takes (air module, arp module, field) and returns
# (witness, props); the witness columns are lists of canonical ints.

def _fibonacci(air, arp, field):
    """tests/test_fri.py:83-97: Fibonacci over F257, 4 rows."""
    fib = air.Fibonacci(field, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


def _dense_start_span(air, arp, field, rows=8):
    """tests/test_density.py: reg0 a[i+1] = a[i]^2 + 1 on rows [1, T - 1)
    (start_at = 1, row 0 free); reg1 b[i+2] = b[i+1] b[i] on rows
    [0, T - 2) (span = 2)."""
    p = field.p
    r0, r1 = air.Register.Register(0), air.Register.Register(1)
    a_now = air.UnivariateTerm(1, r0, air.StepDifference.Steps(0), 1)
    a_next = air.UnivariateTerm(1, r0, air.StepDifference.Steps(1), 1)
    c0 = air.Constraint(density=air.DenseConstraint(start_at=1, span=1))
    c0 += a_next
    c0 -= a_now.pow(2)
    c0 -= 1
    b_nn = air.UnivariateTerm(1, r1, air.StepDifference.Steps(2), 1)
    prod = air.PolyvariateTerm(coeff=1, terms=[
        air.UnivariateTerm(1, r1, air.StepDifference.Steps(1), 1),
        air.UnivariateTerm(1, r1, air.StepDifference.Steps(0), 1),
    ], total_degree=2)
    c1 = air.Constraint(density=air.DenseConstraint(start_at=0, span=2))
    c1 += b_nn
    c1 -= prod
    a = [5, 3] + [0] * (rows - 2)  # a[0] = 5 breaks the rule at row 0, which is free
    for i in range(1, rows - 1):
        a[i + 1] = (a[i] * a[i] + 1) % p
    b = [1, 2] + [0] * (rows - 2)
    for i in range(rows - 2):
        b[i + 2] = b[i + 1] * b[i] % p
    boundary = [air.BoundaryConstraint(r0, 1, a[1]), air.BoundaryConstraint(r1, 0, b[0]),
                air.BoundaryConstraint(r1, 1, b[1])]
    return [a, b], arp.InstanceProperties(num_rows=rows, num_registers=2, constraints=[c0, c1],
                                          boundary_constraints=boundary, field=field)


def _six_registers(air, arp, field, rows=8):
    """tests/test_multi_register.py: a0[i+1] = a0[i] + 1, and for r = 1..5
    a_r[i+1] = a_r[i] * a_{r-1}[i] (polyvariate, across registers)."""
    p = field.p
    regs = [air.Register.Register(i) for i in range(6)]

    def now(r):
        return air.UnivariateTerm(1, regs[r], air.StepDifference.Steps(0), 1)

    def nxt(r):
        return air.UnivariateTerm(1, regs[r], air.StepDifference.Steps(1), 1)

    c = air.Constraint(density=air.DenseConstraint())
    c += nxt(0)
    c -= now(0)
    c -= 1
    constraints = [c]
    for r in range(1, 6):
        c = air.Constraint(density=air.DenseConstraint())
        c += nxt(r)
        c -= air.PolyvariateTerm(coeff=1, terms=[now(r), now(r - 1)], total_degree=2)
        constraints.append(c)
    cols = [[0] * rows for _ in range(6)]
    cols[0][0] = 2
    for r in range(1, 6):
        cols[r][0] = r + 1
    for i in range(rows - 1):
        cols[0][i + 1] = (cols[0][i] + 1) % p
        for r in range(1, 6):
            cols[r][i + 1] = cols[r][i] * cols[r - 1][i] % p
    boundary = [air.BoundaryConstraint(regs[r], 0, cols[r][0]) for r in range(6)]
    boundary.append(air.BoundaryConstraint(regs[5], rows - 1, cols[5][-1]))
    return cols, arp.InstanceProperties(num_rows=rows, num_registers=6, constraints=constraints,
                                        boundary_constraints=boundary, field=field)


def _repeated_sparse(air, arp, field):
    """tests/test_density_repeated_sparse.py: reg0 a[i+1] = a[i]^2 + 1 at
    the even rows only (Repeated(0, 1, 2)); reg1 b[i+1] = 3 b[i] at rows
    {1, 4} only (Sparse). The other rows break both rules on purpose."""
    p = field.p
    r0, r1 = air.Register.Register(0), air.Register.Register(1)
    a_now = air.UnivariateTerm(1, r0, air.StepDifference.Steps(0), 1)
    a_next = air.UnivariateTerm(1, r0, air.StepDifference.Steps(1), 1)
    c0 = air.Constraint(density=air.RepeatedConstraint(start_at=0, span=1, interval=2))
    c0 += a_next
    c0 -= a_now.pow(2)
    c0 -= 1
    b_now = air.UnivariateTerm(1, r1, air.StepDifference.Steps(0), 1)
    b_next = air.UnivariateTerm(1, r1, air.StepDifference.Steps(1), 1)
    c1 = air.Constraint(density=air.SparseConstraint(rows=(1, 4)))
    c1 += b_next
    c1 -= b_now.scaled(3)
    a = [3, 0, 7, 0, 2, 0, 9, 0]
    for i in (0, 2, 4, 6):
        a[i + 1] = (a[i] * a[i] + 1) % p
    b = [2, 5, 0, 7, 4, 0, 8, 6]
    b[2] = 3 * b[1] % p
    b[5] = 3 * b[4] % p
    boundary = [air.BoundaryConstraint(r0, 0, a[0]), air.BoundaryConstraint(r1, 0, b[0])]
    return [a, b], arp.InstanceProperties(num_rows=8, num_registers=2, constraints=[c0, c1],
                                          boundary_constraints=boundary, field=field)


# name -> (instance function, field name, lde factor, FRI final degree + 1, the
# witness cell to tamper with or None, the reference: "oracle" or "jax")
CASES = {
    "fibonacci_f257_fri_degree_4": (_fibonacci, "F257", 16, 4, None, "jax"),
    "dense_start_span_lde8": (_dense_start_span, "F_STARK", 8, 1, (0, 4), "oracle"),
    "six_registers_lde8": (_six_registers, "F_STARK", 8, 1, (3, 4), "oracle"),
    "repeated_sparse_lde8": (_repeated_sparse, "F_STARK", 8, 1, (0, 5), "jax"),
}
TAMPER_CASES = [name for name, case in CASES.items() if case[4] is not None]


def _instance(name, package):
    make, field_name, *_ = CASES[name]
    air, arp, fields = package
    return make(air, arp, fields[field_name])


def oracle_description(props):
    """A port InstanceProperties in the scalar oracle's dict schema
    (scalar_oracle.py:256-264): dense densities and uni/poly terms."""
    p = props.field.p

    def unit(t):
        return (t.register.index, t.steps_difference.value, t.power)

    constraints = []
    for c in props.constraints:
        if not isinstance(c.density, tair.DenseConstraint):
            raise ValueError("the oracle takes dense densities only")
        terms = []
        for t in c.terms:
            if isinstance(t, tair.UnivariateTerm):
                terms.append(("uni", t.coeff % p) + unit(t))
            else:
                coeff = t.coeff
                for u in t.terms:
                    coeff *= u.coeff
                terms.append(("poly", coeff % p, [unit(u) for u in t.terms]))
        constraints.append({"constant": c.constant_term % p, "degree": c.degree,
                            "density": ("dense", c.density.start_at, c.density.span),
                            "terms": terms})
    return {"num_rows": props.num_rows, "num_registers": props.num_registers,
            "constraints": constraints,
            "boundary": [(b.register.index, b.at_row, b.value % p)
                         for b in props.boundary_constraints]}


def _log(transcript_log):
    return [(k, v if isinstance(v, str) else str(v)) for k, v in transcript_log]


@lru_cache(maxsize=None)
def _port_proofs(name):
    """The port's proof of the instance and of its tampered witness (None
    where the case has no tamper), one Prover for both: (bytes, challenge
    log, tampered bytes)."""
    _, _, lde, fri, tamper, _ = CASES[name]
    witness, props = _instance(name, PORT)
    prover = Prover(props.clone(), lde_factor=lde, fri_final_degree_plus_one=fri, device="cpu")
    blob = serialize_proof(prover.prove(witness), props.field)
    log = _log(prover.last_transcript.log)
    tampered = None
    if tamper is not None:
        reg, row = tamper
        witness[reg][row] = (witness[reg][row] + 1) % props.field.p
        tampered = serialize_proof(prover.prove(witness), props.field)
    return blob, log, tampered


@lru_cache(maxsize=None)
def _reference_proof(name):
    """The reference's proof bytes and challenge log: the scalar oracle's,
    or hodor_tpu's prover's where the oracle lacks the density."""
    _, _, lde, fri, _, reference = CASES[name]
    if reference == "oracle":
        witness, props = _instance(name, PORT)
        field = so.OField(props.field.p, props.field.generator)
        proof, log = so.prove(field, witness, oracle_description(props), lde_factor=lde,
                              fri_final_degree_plus_one=fri)
        return so.serialize(proof, field), log
    witness, props = _instance(name, JAX)
    prover = JProver(props.clone(), lde_factor=lde, fri_final_degree_plus_one=fri)
    blob = jproof_io.serialize_proof(prover.prove(witness), props.field)
    return blob, _log(prover.last_transcript.log)


def _verifiers(name):
    """(port verifier, port field), (hodor_tpu verifier, its field)."""
    lde = CASES[name][2]
    _, props = _instance(name, PORT)
    _, jprops = _instance(name, JAX)
    return ((Verifier(props, lde_factor=lde), props.field),
            (JVerifier(jprops, lde_factor=lde), jprops.field))


def test_oracle_description_of_the_vdf_matches_the_oracle_s_own():
    """The converter gives the oracle's hand-written VDF description."""
    from hodor_tpu_torch.models import VDF

    _, props = VDF(F_STARK, 1, 2, 7).into_arp()
    _, want = so.vdf_instance(so.F_STARK, 1, 2, 7)
    assert oracle_description(props) == want


# Repeated / Sparse is held against a hodor_tpu prove, which compiles for
# over a minute on a fresh JAX cache: its byte comparisons are `slow`;
# its verifier and tamper checks stay in tier-1.
REFERENCE_CASES = [pytest.param(name, marks=pytest.mark.slow) if name == "repeated_sparse_lde8"
                   else name for name in CASES]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_port_proof_bytes_equal_the_reference(name):
    assert _port_proofs(name)[0] == _reference_proof(name)[0]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_port_challenge_log_equals_the_reference(name):
    assert _port_proofs(name)[1] == _reference_proof(name)[1]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_port_verifier_accepts_the_reference_proof(name):
    (verifier, field), _ = _verifiers(name)
    assert verifier.verify(deserialize_proof(_reference_proof(name)[0], field))


@pytest.mark.parametrize("name", list(CASES))
def test_both_verifiers_accept_the_port_proof(name):
    port_bytes = _port_proofs(name)[0]
    (verifier, field), (jverifier, jfield) = _verifiers(name)
    assert jverifier.verify(jproof_io.deserialize_proof(port_bytes, jfield))
    assert verifier.verify(deserialize_proof(port_bytes, field))


@pytest.mark.parametrize("name", TAMPER_CASES)
def test_both_verifiers_reject_a_proof_of_a_tampered_witness(name):
    tampered = _port_proofs(name)[2]
    (verifier, field), (jverifier, jfield) = _verifiers(name)
    assert not verifier.verify(deserialize_proof(tampered, field))
    assert not jverifier.verify(jproof_io.deserialize_proof(tampered, jfield))


def test_fri_to_degree_four_carries_four_final_coefficients():
    (verifier, field), _ = _verifiers("fibonacci_f257_fri_degree_4")
    proof = deserialize_proof(_port_proofs("fibonacci_f257_fri_degree_4")[0], field)
    assert len(proof.fri_proof_h1.final_coefficients) == 4
    assert len(proof.fri_proof_h2.final_coefficients) == 4
    proof.fri_proof_h1.final_coefficients[3] = (proof.fri_proof_h1.final_coefficients[3] + 1) \
        % field.p
    assert not verifier.verify(proof)
