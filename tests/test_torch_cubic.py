"""This slice as a whole on CPU tensors: the cubic VDF instance against
the JAX package's, its satisfiability, and the vdf_fstark_t32 golden
under the other two NTT level forms. (The cubic golden itself runs with
the other goldens in tests/test_torch_prover.py.)"""

import json
import os

import pytest
import torch

from hodor_tpu.field import F_STARK as JF_STARK
from hodor_tpu.models import CubicVDF as JCubicVDF
from hodor_tpu_torch.arp import ARPInstance
from hodor_tpu_torch.errors import UnsatisfiedError
from hodor_tpu_torch.field import F_STARK, LimbOps
from hodor_tpu_torch.models import VDF, CubicVDF
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_cubic_witness_and_boundaries_match_jax():
    witness, props = CubicVDF(F_STARK, 3, 5, 40).into_arp()
    jwitness, jprops = JCubicVDF(JF_STARK, 3, 5, 40).into_arp()
    assert [list(map(int, reg)) for reg in jwitness] == witness
    assert props.num_rows == jprops.num_rows == 41
    assert props.num_registers == jprops.num_registers == 4
    assert len(props.constraints) == len(jprops.constraints) == 4
    def boundaries(p):
        return [(b.register.kind, b.register.index, b.at_row, b.value)
                for b in p.boundary_constraints]

    assert boundaries(props) == boundaries(jprops)


def test_cubic_arp_satisfiability():
    ops = LimbOps(F_STARK, "cpu")
    witness, props = CubicVDF(F_STARK, 1, 1, 15).into_arp()
    ARPInstance.is_satisfied(props, witness, ops)
    witness[2][5] = (witness[2][5] + 1) % F_STARK.p
    with pytest.raises(UnsatisfiedError):
        ARPInstance.is_satisfied(props, witness, ops)


@pytest.mark.parametrize("ntt_impl", ["two_step", "fused"])
def test_vdf_golden_under_other_ntt_impls(ntt_impl):
    witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu",
                    ntt_impl=ntt_impl)
    proof = prover.prove(witness)
    assert Verifier(props, lde_factor=16).verify(proof)
    with open(os.path.join(GOLDEN, "vdf_fstark_t32.proof"), "rb") as f:
        assert serialize_proof(proof, F_STARK) == f.read()
    with open(os.path.join(GOLDEN, "vdf_fstark_t32.challenges.json")) as f:
        expected = [tuple(e) for e in json.load(f)]
    assert [(k, v if isinstance(v, str) else str(v))
            for k, v in prover.last_transcript.log] == expected
