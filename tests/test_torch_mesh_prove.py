"""Prover(mesh=...) on gloo ranks spawned on the CPU: at W = 2 and 4
every rank reproduces tests/golden/vdf_fstark_t32 and
cubic_vdf_fstark_t32 byte for byte with the same challenge log, both
verifiers accept the proof and reject a tampered copy, a 4-row trace and
lde 2 (the replicated fallbacks at W = 4) prove as on one device, each rank's
f-LDE block has N/W rows (the port of tests/test_distributed.py's
per-device shrink), prove_batch under a mesh equals the sequential
proves (tests/test_batch.py's mesh case); and the dry runs of
tools/dryrun.py on the CPU. Checkpoint/resume under a mesh:
tests/test_torch_mesh_checkpoint.py.

Each W is one spawn of W ranks that proves everything; the ranks import
this module, so JAX is imported only inside the tests."""

import json
import os

import pytest

from hodor_tpu_torch import air
from hodor_tpu_torch.config import ProofSystemConfig
from hodor_tpu_torch.field import F257, F_STARK
from hodor_tpu_torch.models import VDF, CubicVDF
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools.dryrun import dryrun_multichip, dryrun_multihost, run_ranks
from hodor_tpu_torch.verifier import Verifier

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NAMES = ["vdf_fstark_t32", "cubic_vdf_fstark_t32"]
WORLDS = [2, 4]


def _instance(name):
    if name == "cubic_vdf_fstark_t32":
        return CubicVDF(F_STARK, 1, 1, 31).into_arp()
    return VDF(F_STARK, 1, 2, 31).into_arp()


def _fibonacci():
    """tests/test_fri.py:83-97: Fibonacci over F257, 4 rows."""
    fib = air.Fibonacci(F257, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


# name -> (instance, lde factor, FRI final degree + 1). At W = 4 these take
# the mesh prove's replicated fallbacks: the 4-row trace the ALI's full
# term coset-LDE (T < 2W) and full G interpolant (D/W < 2), lde 2 the
# prover's full f- and G-LDEs (W does not divide the factor)
SMALL = {"fibonacci_f257_fri_degree_4": (_fibonacci, 16, 4),
         "vdf_fstark_t32_lde2": (lambda: VDF(F_STARK, 1, 2, 31).into_arp(), 2, 1)}


def _rank_proves(mesh, device):
    """One rank: both goldens (the cubic one through from_config), the
    small shapes' proofs under the mesh and on this rank's device alone,
    the f-LDE block's shape, a two-witness prove_batch and its sequential
    proves."""
    out = {}
    for name, (make, lde, fri) in SMALL.items():
        witness, props = make()
        out[name] = [serialize_proof(Prover(props.clone(), lde, fri, device=device, mesh=m)
                                     .prove(witness), props.field) for m in (mesh, None)]
    for name in NAMES:
        witness, props = _instance(name)
        config = ProofSystemConfig(lde_factor=16, fri_final_degree_plus_one=1, mesh=mesh)
        prover = (Prover.from_config(props.clone(), config, device=device)
                  if name == "cubic_vdf_fstark_t32" else
                  Prover(props.clone(), 16, 1, device=device, mesh=mesh))
        proof = serialize_proof(prover.prove(witness), F_STARK)
        log = [(k, v if isinstance(v, str) else str(v)) for k, v in prover.last_transcript.log]
        out[name] = (proof, log)
    witness, props = _instance("vdf_fstark_t32")
    prover = Prover(props.clone(), 16, 1, device=device, mesh=mesh)
    polys = prover.arp.calculate_witness_polys(prover.arp.encode_witness(witness))
    out["f_lde_block"] = tuple(prover._lde(polys).shape)
    other, _ = VDF(F_STARK, 3, 5, 31).into_arp()
    out["batch"] = [serialize_proof(p, F_STARK) for p in prover.prove_batch([witness, other])]
    out["sequential"] = [out["vdf_fstark_t32"][0], serialize_proof(prover.prove(other), F_STARK)]
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """W -> the W ranks' results, one spawn per W, made on first use."""
    cache = {}

    def get(w):
        if w not in cache:
            rdv = tmp_path_factory.mktemp(f"rendezvous_w{w}") / "store"
            cache[w] = run_ranks(_rank_proves, w, device="cpu", backend="gloo",
                                 init_method=f"file://{rdv}", timeout=180)
        return cache[w]

    return get


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.proof"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, f"{name}.challenges.json")) as f:
        return data, [tuple(e) for e in json.load(f)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("w", WORLDS)
def test_mesh_proof_equals_golden_on_every_rank(spawned, w, name):
    data, log = _golden(name)
    for r, ranks in enumerate(spawned(w)):
        assert ranks[name][0] == data, f"rank {r}: proof bytes"
        assert ranks[name][1] == log, f"rank {r}: challenge log"


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("w", WORLDS)
def test_both_verifiers_accept_mesh_proof_and_reject_tampered(spawned, w, name):
    import hodor_tpu.proof_io as jproof_io
    from hodor_tpu.field import F_STARK as JF_STARK
    from hodor_tpu.models import CubicVDF as JCubicVDF, VDF as JVDF
    from hodor_tpu.verifier import Verifier as JVerifier

    _, props = _instance(name)
    _, jprops = (JCubicVDF(JF_STARK, 1, 1, 31) if name == "cubic_vdf_fstark_t32"
                 else JVDF(JF_STARK, 1, 2, 31)).into_arp()
    data = spawned(w)[-1][name][0]
    for make in (lambda: (Verifier(props, lde_factor=16), deserialize_proof(data, F_STARK)),
                 lambda: (JVerifier(jprops, lde_factor=16),
                          jproof_io.deserialize_proof(data, JF_STARK))):
        verifier, proof = make()
        assert verifier.verify(proof)
        verifier, proof = make()
        proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % F_STARK.p
        assert not verifier.verify(proof)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("w", WORLDS)
def test_mesh_proof_of_small_shapes_equals_one_device(spawned, w, name):
    """Every rank's mesh proof is its one-device proof, byte for byte,
    and the port's verifier accepts it and rejects a tampered copy."""
    make, lde, _ = SMALL[name]
    _, props = make()
    for r, (mesh_proof, alone) in enumerate(ranks[name] for ranks in spawned(w)):
        assert mesh_proof == alone, f"rank {r}"
    assert Verifier(props, lde_factor=lde).verify(deserialize_proof(mesh_proof, props.field))
    proof = deserialize_proof(mesh_proof, props.field)
    proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % props.field.p
    assert not Verifier(props, lde_factor=lde).verify(proof)


@pytest.mark.parametrize("w", WORLDS)
def test_each_rank_holds_n_over_w_rows_of_the_f_ldes(spawned, w):
    """32 rows at lde 16 are 512 LDE rows, 2 registers: each rank holds
    its 512 / W of them."""
    for ranks in spawned(w):
        assert ranks["f_lde_block"] == (2, 512 // w, F_STARK.n16)


@pytest.mark.parametrize("w", WORLDS)
def test_prove_batch_under_mesh_equals_sequential_proves(spawned, w):
    for ranks in spawned(w):
        assert ranks["batch"] == ranks["sequential"]
        assert ranks["batch"][0] != ranks["batch"][1]


def test_dryrun_multichip_on_cpu(capsys):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK on 4 ranks" in capsys.readouterr().out


def test_dryrun_multihost_on_cpu(capsys):
    dryrun_multihost(2, 2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multihost OK: 2 hosts x 2 ranks" in out
    assert '"four_step_ntt": {"all_to_all": 3, "all_gather": 0}' in out
