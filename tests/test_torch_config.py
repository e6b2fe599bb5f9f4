"""The port's ProofSystemConfig (hodor_tpu_torch.config) and
Prover.from_config: the JAX package's validation cases, the same fields
and registries, a mesh that must be a torch.distributed DeviceMesh, and
from_config giving the bytes of the Prover built by hand."""

import dataclasses
import os

import pytest
import torch
import torch.distributed as dist

import hodor_tpu.config as jconfig
import hodor_tpu_torch.air as tair
import hodor_tpu_torch.config as config
from hodor_tpu_torch.config import ProofSystemConfig
from hodor_tpu_torch.field import F257
from hodor_tpu_torch.parallel import make_mesh
from hodor_tpu_torch.parallel.multihost import init_multihost
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover

torch.set_num_threads(1)


def _fib():
    fib = tair.Fibonacci(F257, final_b=5, at_step=3)
    tracer = tair.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


@pytest.mark.parametrize("kwargs", [
    {"lde_factor": 12}, {"fri_final_degree_plus_one": 3}, {"fri_final_degree_plus_one": 0},
    {"transcript": "sha3"}, {"iop_hash": "poseidon"}, {"fri_impl": "by_coefficients"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_validation_matches_hodor_tpu(kwargs):
    with pytest.raises(ValueError):
        ProofSystemConfig(**kwargs)
    with pytest.raises(ValueError):
        jconfig.ProofSystemConfig(**kwargs)


def test_config_fields_and_registries_match_hodor_tpu():
    """The JAX package's fields but its `profile`, which nothing reads
    there either: the port's prove always records its spans."""
    assert [(f.name, f.default) for f in dataclasses.fields(ProofSystemConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jconfig.ProofSystemConfig)
         if f.name != "profile"]
    for name in ("TRANSCRIPTS", "IOP_HASHES", "FRI_IMPLS"):
        assert getattr(config, name) == getattr(jconfig, name)
    ProofSystemConfig(lde_factor=8)


def test_a_mesh_is_refused_until_multi_device(tmp_path):
    """Multi-device proving is here: a mesh that is no torch.distributed
    DeviceMesh is refused, a DeviceMesh (one gloo rank) is taken."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ProofSystemConfig(mesh=object())
    init_multihost(f"file://{tmp_path / 'store'}", 1, 0, "gloo", "cpu")
    try:
        mesh = make_mesh(1, "cpu")
        assert ProofSystemConfig(mesh=mesh).mesh is mesh
    finally:
        dist.destroy_process_group()


def test_prover_from_config_matches_direct():
    witness, props = _fib()
    cfg = ProofSystemConfig(lde_factor=16, fri_final_degree_plus_one=1)
    prover = Prover.from_config(props.clone(), cfg, device="cpu")
    assert prover.device.type == "cpu"
    got = serialize_proof(prover.prove(witness), F257)
    want = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                  device="cpu").prove(witness)
    assert got == serialize_proof(want, F257)
    with open(os.path.join(os.path.dirname(__file__), "golden", "fib_f257.proof"), "rb") as f:
        assert got == f.read()


def test_prover_defaults_to_the_card():
    """Without a device argument the prover is built for the card: the
    tests ask for the CPU, and here, with no card, the default raises
    instead of stepping back to the CPU."""
    _, props = _fib()
    for build in (lambda: Prover(props.clone(), 16, 1),
                  lambda: Prover.from_config(props.clone(), ProofSystemConfig())):
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
