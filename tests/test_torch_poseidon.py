"""The Poseidon chain (models/poseidon.py) on the CPU: its witness against a
plain Hades permutation, the native chain against the Python one, its
degree-3 proofs against the benchmark's plain reference prover
(stark_bench/reference/stark.py on stark_bench/configs/poseidon_chain.py)
in every layer the judge compares, the verifier on them, the
satisfiability check on a broken witness, and the ALI's term-LDE factor
at each maximum degree."""

import dataclasses
import random

import pytest

from hodor_tpu_torch.air.constraint import (
    BoundaryConstraint,
    Constraint,
    DenseConstraint,
    Register,
    StepDifference,
    UnivariateTerm,
)
from hodor_tpu_torch.ali.instance import ALIInstance
from hodor_tpu_torch.arp import ARPInstance, InstanceProperties
from hodor_tpu_torch.errors import UnsatisfiedError
from hodor_tpu_torch.field import F_STARK, LimbOps
from hodor_tpu_torch.models import PoseidonChain
from hodor_tpu_torch.models import poseidon
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools import bench
from hodor_tpu_torch.utils.native import u64_rows_to_ints
from hodor_tpu_torch.verifier import Verifier
from stark_bench import judge
from stark_bench.program import flatten
from stark_bench.reference import stark
from stark_bench.reference.field import PlainField
from stark_bench.spec import Spec

P = F_STARK.p
# (log2 rows, lde factor): 2^7 rows at the benchmark's lde 16; 2^8 rows at
# lde 4, which keeps the CPU prove short. Both cross a permutation (91 rows).
SHAPES = [(7, 16), (8, 4)]


def _start(log_rows):
    rng = random.Random(1000 + log_rows)
    return rng.randrange(1, P), rng.randrange(1, P)


@pytest.fixture(scope="module")
def air():
    return Spec().air("poseidon_chain")


@pytest.fixture(scope="module")
def proved():
    """{(log_rows, lde): (witness, props, prover, proof)} of the port."""
    out = {}
    for log_rows, lde in SHAPES:
        witness, props = PoseidonChain(F_STARK, *_start(log_rows), (1 << log_rows) - 1,
                                       witness="python").into_arp()
        prover = Prover(props.clone(), lde_factor=lde, fri_final_degree_plus_one=1,
                        device="cpu")
        out[log_rows, lde] = (witness, props, prover, prover.prove(witness))
    return out


def test_state_at_each_permutation_start_is_hades_applied_n_times(air):
    start = (11, 22)
    columns, _ = PoseidonChain(F_STARK, *start, 4 * 91, witness="python").into_arp()
    state = [11, 22, 2]
    for n in range(5):
        row = 91 * n
        assert [(columns[j][row] - columns[6 + j][row]) % P for j in range(3)] == state
        state = air.hades(P, state)
    assert columns[9] == [int(r % 91 < 4 or r % 91 >= 87) for r in range(4 * 91 + 1)]
    assert poseidon.round_constants(P) == tuple(map(tuple, air.round_constants(P)))


@pytest.mark.parametrize("steps", [90, 300])
def test_native_witness_equals_the_python_chain(steps):
    py, py_props = PoseidonChain(F_STARK, 5, 7, steps, witness="python").into_arp()
    native, native_props = PoseidonChain(F_STARK, 5, 7, steps, witness="native").into_arp()
    assert native.shape == (10, steps + 1, 4)
    assert [u64_rows_to_ints(native[i]) for i in range(10)] == py
    assert [b.value for b in native_props.boundary_constraints] == \
        [b.value for b in py_props.boundary_constraints]


def test_instance_has_ten_registers_six_constraints_six_boundaries():
    _, props = PoseidonChain(F_STARK, 1, 2, 127, witness="python").into_arp()
    assert props.num_registers == 10
    assert [c.degree for c in props.constraints] == [3, 3, 3, 2, 2, 2]
    assert [(b.register.index, b.at_row) for b in props.boundary_constraints] == \
        [(0, 0), (1, 0), (2, 0), (0, 127), (1, 127), (2, 127)]


@pytest.mark.parametrize("log_rows, lde", SHAPES)
def test_proof_equals_the_plain_reference_in_every_layer(proved, air, log_rows, lde):
    *_, proof = proved[log_rows, lde]
    want = stark.prove(PlainField(P, 3), air, _start(log_rows), (1 << log_rows) - 1, lde, 1)
    got = flatten(proof)
    checks = judge.compare(want, [got])
    assert judge.passed(checks), checks
    assert judge.failed(want, [got]) == 0


def test_ali_at_degree_three(proved):
    _, _, prover, _ = proved[7, 16]
    ali = prover.ali
    assert ali.max_constraint_power == 3 and ali.term_lde_factor == 4
    assert ali.constraints_domain.size == 4 * 128
    assert len(ali.all_masks) == 13 and len(ali.term_ldes) == 15


@pytest.mark.parametrize("log_rows, lde", SHAPES)
def test_verifier_accepts_and_rejects_a_changed_boundary_value(proved, log_rows, lde):
    _, props, _, proof = proved[log_rows, lde]
    assert Verifier(props, lde_factor=lde).verify(proof)
    for i in (0, 5):
        bad = props.clone()
        bc = bad.boundary_constraints[i]
        bad.boundary_constraints[i] = dataclasses.replace(bc, value=(bc.value + 1) % P)
        assert not Verifier(bad, lde_factor=lde).verify(proof)


def test_a_changed_cube_cell_fails_the_satisfiability_check():
    witness, props = PoseidonChain(F_STARK, 3, 4, 127, witness="python").into_arp()
    ops = LimbOps(F_STARK, device="cpu")
    ARPInstance.is_satisfied(props, witness, ops)
    witness[4][100] = (witness[4][100] + 1) % P  # a1 at row 100
    with pytest.raises(UnsatisfiedError):
        ARPInstance.is_satisfied(props, witness, ops)


def _degree_instance(degree):
    """One register, rows 16: x' = x^degree, and x at row 0."""
    reg = Register.Register(0)
    c = Constraint(density=DenseConstraint())
    c += UnivariateTerm(1, reg, StepDifference.Steps(1), 1)
    c -= UnivariateTerm(1, reg, StepDifference.Steps(0), degree)
    return InstanceProperties(num_rows=16, num_registers=1, constraints=[c],
                              boundary_constraints=[BoundaryConstraint(reg, 0, 2)],
                              field=F_STARK)


@pytest.mark.parametrize("degree, factor", [(1, 1), (2, 2), (3, 4), (4, 4)])
def test_term_lde_factor_fills_the_constraints_domain(degree, factor):
    ops = LimbOps(F_STARK, device="cpu")
    ali = ALIInstance(ARPInstance.from_instance(_degree_instance(degree), ops))
    assert ali.max_constraint_power == degree
    assert ali.term_lde_factor == factor and ali.constraints_domain.size == 16 * factor


def test_bench_estimate_rounds_the_degree_up(proved):
    """tools/bench.py's CPU estimate sizes D as the prover does: 4T at
    degree 3, whose log2 is whole."""
    _, _, prover, _ = proved[7, 16]
    r, m, t, lde = 10, 13, 128, 16
    d = 4 * t
    lg_t, lg_d = 7, 9
    h1, h2 = t * lde, d * lde
    muls = (r * (t // 2) * lg_t + r * lde * ((t // 2) * lg_t + t)
            + m * 4 * ((t // 2) * lg_t + t) + 5 * d
            + (d // 2) * lg_d + lde * ((d // 2) * lg_d + d)
            + (2 * m + 3) * h1 + 2 * h2 + 3 * (h1 + h2))
    assert bench.reference_prove_estimate_s(prover, t, lde) == muls / bench.BASELINE_MULS_PER_S
