"""The port's device-to-host fetches in a warm prove (the port of
tests/test_transfers.py). Every fetch of the port goes through one helper,
field.limbs.fetch_together (merkle.tree.fetch_roots calls it too); the
test wraps it in every module that binds it and counts the calls of a
warm Prover.prove of fib_f257. A warm prove makes five, one per
Fiat-Shamir commit point (src/prover/mod.rs:82-151):

  1. stage 1: the f roots (fetch_roots);
  2. stage G: the G root (fetch_roots);
  3. DEEP: f(mz) and g(z) (ALIInstance._deep);
  4. FRI: every root of both ladders and both final coefficient vectors
     (run_ladders);
  5. queries: every opening of the FRI chains and of the f and g oracles
     (gather_chain_queries).

On the CPU a fetch costs nothing, but the count is structural: the same
code runs on the card. Under a W = 2 mesh each rank makes the same five
(the sharded FRI ladder takes its challenges on the device and adds no
fetch a round; the sharded openings join the one query fetch)."""

import os
import sys

import torch

from hodor_tpu_torch import air
from hodor_tpu_torch.field import F257, limbs
from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools.dryrun import run_ranks
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

# the callers of fetch_together in a warm prove, in order
EXPECTED_FETCHES = ["fetch_roots", "fetch_roots", "_deep", "run_ladders", "gather_chain_queries"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fib_f257.proof")


def _fib():
    fib = air.Fibonacci(F257, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


def _counted_warm_prove(device, mesh=None):
    """A cold prove, then a warm one with fetch_together counted in every
    module of the port that binds it. Returns (warm proof bytes, the
    fetches' callers)."""
    witness, props = _fib()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=device,
                    mesh=mesh)
    prover.prove(witness)
    real = limbs.fetch_together
    calls = []

    def counting(tensors):
        calls.append(sys._getframe(1).f_code.co_name)
        return real(tensors)

    bound = [m for name, m in sys.modules.items() if name.startswith("hodor_tpu_torch")
             and getattr(m, "fetch_together", None) is real]
    for m in bound:
        m.fetch_together = counting
    try:
        proof = serialize_proof(prover.prove(witness), F257)
    finally:
        for m in bound:
            m.fetch_together = real
    return proof, calls


def _rank_fetches(mesh, device):
    return _counted_warm_prove(device, mesh)


def test_warm_prove_fetch_count_on_one_device():
    proof, calls = _counted_warm_prove("cpu")
    with open(GOLDEN, "rb") as f:
        assert proof == f.read()
    assert calls == EXPECTED_FETCHES


def test_warm_prove_fetch_count_on_each_rank_of_a_mesh(tmp_path):
    ranks = run_ranks(_rank_fetches, 2, device="cpu", backend="gloo",
                      init_method=f"file://{tmp_path / 'store'}", timeout=120)
    with open(GOLDEN, "rb") as f:
        data = f.read()
    _, props = _fib()
    for r, (proof, calls) in enumerate(ranks):
        assert proof == data, f"rank {r}"
        assert calls == EXPECTED_FETCHES, f"rank {r}"
    assert Verifier(props, lde_factor=16).verify(deserialize_proof(data, F257))
