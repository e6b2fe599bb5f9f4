"""The whole port on CPU tensors against the golden vectors: the port
reproduces tests/golden/fib_f257, vdf_fstark_t32 and cubic_vdf_fstark_t32
byte for byte with
the same Fiat-Shamir challenge log, hodor_tpu's verifier accepts the
port's proofs, the port's verifier accepts the golden bytes, and both
reject tampered proofs. Also the port's FRI layer on its own."""

import json
import os
import random
from functools import lru_cache

import pytest
import torch

import hodor_tpu.proof_io as jproof_io
import hodor_tpu.air as jair
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK
from hodor_tpu.models import CubicVDF as JCubicVDF, VDF as JVDF
from hodor_tpu.verifier import Verifier as JVerifier
import hodor_tpu_torch.air as tair
from hodor_tpu_torch.arp import ARPInstance
from hodor_tpu_torch.errors import UnsatisfiedError
from hodor_tpu_torch.field import F257, F_STARK, LimbOps
from hodor_tpu_torch.fri import NaiveFriIop
from hodor_tpu_torch.models import VDF, CubicVDF
from hodor_tpu_torch.ntt import lde
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NAMES = ["fib_f257", "vdf_fstark_t32", "cubic_vdf_fstark_t32"]


def _fib(air, field):
    fib = air.Fibonacci(field, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


def _instance(name):
    """(port witness, port props, port field, jax props, jax field)."""
    if name == "fib_f257":
        w, props = _fib(tair, F257)
        _, jprops = _fib(jair, JF257)
        return w, props, F257, jprops, JF257
    if name == "cubic_vdf_fstark_t32":
        w, props = CubicVDF(F_STARK, 1, 1, 31).into_arp()
        _, jprops = JCubicVDF(JF_STARK, 1, 1, 31).into_arp()
        return w, props, F_STARK, jprops, JF_STARK
    w, props = VDF(F_STARK, 1, 2, 31).into_arp()
    _, jprops = JVDF(JF_STARK, 1, 2, 31).into_arp()
    return w, props, F_STARK, jprops, JF_STARK


@lru_cache(maxsize=None)
def _proved(name):
    """One CPU prove per instance, shared by the tests of this module."""
    witness, props, field, _, _ = _instance(name)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    proof = prover.prove(witness)
    log = [(k, v if isinstance(v, str) else str(v)) for k, v in prover.last_transcript.log]
    return serialize_proof(proof, field), log


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.proof"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, f"{name}.challenges.json")) as f:
        log = [tuple(e) for e in json.load(f)]
    return data, log


@pytest.mark.parametrize("name", NAMES)
def test_port_reproduces_golden_proof_bytes(name):
    assert _proved(name)[0] == _golden(name)[0]


@pytest.mark.parametrize("name", NAMES)
def test_port_reproduces_golden_challenge_log(name):
    assert _proved(name)[1] == _golden(name)[1]


@pytest.mark.parametrize("name", NAMES)
def test_jax_verifier_accepts_port_proof(name):
    _, _, _, jprops, jfield = _instance(name)
    proof = jproof_io.deserialize_proof(_proved(name)[0], jfield)
    assert JVerifier(jprops, lde_factor=16).verify(proof)


@pytest.mark.parametrize("name", NAMES)
def test_port_verifier_accepts_golden_bytes(name):
    _, props, field, _, _ = _instance(name)
    proof = deserialize_proof(_golden(name)[0], field)
    assert Verifier(props, lde_factor=16).verify(proof)
    assert serialize_proof(proof, field) == _golden(name)[0]


@pytest.mark.parametrize("tamper", ["f_at_z_m", "g_query_value", "fri_final_coefficient"])
@pytest.mark.parametrize("name", NAMES)
def test_both_verifiers_reject_tampered_proof(name, tamper):
    _, props, field, jprops, jfield = _instance(name)
    data = _proved(name)[0]
    for verifier, proof in ((Verifier(props, lde_factor=16), deserialize_proof(data, field)),
                            (JVerifier(jprops, lde_factor=16),
                             jproof_io.deserialize_proof(data, jfield))):
        if tamper == "f_at_z_m":
            proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % field.p
        elif tamper == "g_query_value":
            proof.g_query.value = (proof.g_query.value + 1) % field.p
        else:
            fc = proof.fri_proof_h2.final_coefficients
            fc[0] = (fc[0] + 1) % field.p
        assert not verifier.verify(proof)


def test_arp_satisfiability():
    ops = LimbOps(F_STARK, "cpu")
    witness, props = VDF(F_STARK, 3, 5, 15).into_arp()
    ARPInstance.is_satisfied(props, witness, ops)
    witness[0][7] = (witness[0][7] + 1) % F_STARK.p
    with pytest.raises(UnsatisfiedError):
        ARPInstance.is_satisfied(props, witness, ops)


def _fri_lde(ops, log_t, factor, seed):
    rng = random.Random(seed)
    coeffs = ops.encode([rng.randrange(ops.field.p) for _ in range(1 << log_t)])
    return lde(ops, coeffs, factor)


def test_fri_values_vs_coefficients_equivalence():
    ops = LimbOps(F257, "cpu")
    lde_values = _fri_lde(ops, 3, 8, 41)
    by_vals = NaiveFriIop.proof_from_lde(ops, lde_values, 8, 1)
    by_coeffs = NaiveFriIop.proof_from_lde_through_coefficients(ops, lde_values, 8, 1)
    assert by_vals.challenges == by_coeffs.challenges
    assert by_vals.get_roots() == by_coeffs.get_roots()
    assert by_vals.final_coefficients == by_coeffs.final_coefficients
    for a, b in zip(by_vals.intermediate_values, by_coeffs.intermediate_values):
        assert torch.equal(a, b)


def test_fri_prototype_verifier_sweep_and_query_rejection():
    ops = LimbOps(F257, "cpu")
    lde_values = _fri_lde(ops, 2, 4, 42)
    proto = NaiveFriIop.proof_from_lde(ops, lde_values, 4, 1)
    for i in range(1, lde_values.shape[0], 2):
        assert NaiveFriIop.verify_prototype(ops, proto, lde_values, i), i
    idx = 5
    proof = NaiveFriIop.prototype_into_proof(ops, proto, lde_values, idx)
    expected = int(ops.decode(lde_values[idx]))
    assert NaiveFriIop.verify_proof(proof, idx, expected, F257)
    assert not NaiveFriIop.verify_proof(proof, idx, (expected + 1) % F257.p, F257)
    proof.final_coefficients[0] = (proof.final_coefficients[0] + 1) % F257.p
    assert not NaiveFriIop.verify_proof(proof, idx, expected, F257)
