"""Batch proving in the port (Prover.prove_batch) on CPU tensors: each
lane's proof is byte-identical to the port's sequential prove of the same
witness and to hodor_tpu's prove_batch, every lane carries a distinct
witness (distinct roots, so distinct challenges in every lane, and a lane
mix-up shows), and the batched pieces (the fold with a lane axis, the
batched Merkle tree) equal their per-lane forms. Tolerance 0 for limbs,
digests and proof bytes."""

import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.air as jair
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK
from hodor_tpu.field.pallas_kernels import pallas_fri_fold
from hodor_tpu.proof_io import serialize_proof as jserialize_proof
from hodor_tpu.prover import Prover as JProver
import hodor_tpu_torch.air as tair
from hodor_tpu_torch.errors import DivisionByZeroError
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.fri.fri import fold_twiddles
from hodor_tpu_torch.merkle.tree import MerkleTree, fetch_roots
from hodor_tpu_torch.models import VDF
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _fib(air, field):
    fib = air.Fibonacci(field, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


def _prover(props):
    return Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")


@lru_cache(maxsize=None)
def _fib_lanes():
    """The honest fib_f257 witness and a corrupted one whose Fiat-Shamir z
    avoids the LDE domain (F257 is tiny: z can fall inside it and the
    prover then rightly raises, as tests/test_batch.py explains), with
    the port's sequential proof bytes of both."""
    witness, props = _fib(tair, F257)
    prover = _prover(props)
    for delta in range(1, 40):
        corrupted = [list(col) for col in witness]
        corrupted[0][2] = (corrupted[0][2] + delta) % F257.p
        try:
            blob = serialize_proof(prover.prove(corrupted), F257)
        except DivisionByZeroError:
            continue
        return witness, corrupted, props, [serialize_proof(prover.prove(witness), F257), blob]
    raise AssertionError("no corruption delta avoided the LDE domain")


def test_prove_batch_fib_f257_matches_sequential_and_hodor_tpu():
    witness, corrupted, props, singles = _fib_lanes()
    prover = _prover(props)
    batch = prover.prove_batch([witness, corrupted])
    blobs = [serialize_proof(pf, F257) for pf in batch]
    assert blobs == singles and blobs[0] != blobs[1]
    assert all(r.name.startswith("batch:") for r in prover.last_timings.records)
    assert len(prover.last_transcripts) == 2
    _, jprops = _fib(jair, JF257)
    jprover = JProver(jprops.clone(), lde_factor=16, fri_final_degree_plus_one=1)
    assert [jserialize_proof(pf, JF257) for pf in jprover.prove_batch([witness, corrupted])] \
        == blobs
    verifier = Verifier(props, lde_factor=16)
    assert verifier.verify(batch[0])


def _rejected(verifier, proof) -> bool:
    try:
        return not verifier.verify(proof)
    except Exception:
        return True


def test_prove_batch_vdf_t32_lanes():
    """Starts (1, 2) and (3, 5) under the first one's instance: lane 0 is
    the golden proof, lane 1 its own sequential prove; lane 0 verifies
    and lane 1 is rejected."""
    w0, props = VDF(F_STARK, 1, 2, 31).into_arp()
    w1, _ = VDF(F_STARK, 3, 5, 31).into_arp()
    prover = _prover(props)
    batch = prover.prove_batch([w0, w1])
    with open(os.path.join(GOLDEN, "vdf_fstark_t32.proof"), "rb") as f:
        assert serialize_proof(batch[0], F_STARK) == f.read()
    assert serialize_proof(batch[1], F_STARK) == serialize_proof(prover.prove(w1), F_STARK)
    verifier = Verifier(props, lde_factor=16)
    assert verifier.verify(batch[0])
    assert _rejected(verifier, batch[1])


@pytest.mark.parametrize("case", ["one_lane", "no_boundary_constraints"])
def test_prove_batch_goes_sequential(case):
    """B == 1, and an instance without boundary constraints, are proved by
    sequential prove() calls, as in the JAX package."""
    witness, corrupted, props, singles = _fib_lanes()
    if case == "one_lane":
        prover = _prover(props)
        (proof,) = prover.prove_batch([witness])
        assert serialize_proof(proof, F257) == singles[0]
    else:
        props = props.clone()
        props.boundary_constraints = []
        prover = _prover(props)
        want = [serialize_proof(prover.prove(w), F257) for w in (witness, corrupted)]
        got = [serialize_proof(pf, F257) for pf in prover.prove_batch([witness, corrupted])]
        assert got == want and got[0] != got[1]
    assert not any(r.name.startswith("batch:") for r in prover.last_timings.records)


def _limbs(rng, shape, field):
    """Uniform canonical limbs of `field` (numpy uint32)."""
    if field is F257:
        out = np.zeros(shape + (field.n16,), dtype=np.uint32)
        out[..., 0] = rng.integers(0, field.p, size=shape)
        return out
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= 0x7FF
    return limbs


def _roots(rng, shape):
    """Random (..., 8) int32 root digests."""
    return torch.from_numpy(
        rng.integers(-1 << 31, 1 << 31, size=shape + (8,), dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("lanes,half", [(2, 512), (3, 7)])
@pytest.mark.parametrize("field", [F_STARK, F257], ids=lambda f: f.name)
def test_fri_fold_plain_with_lanes_equals_lane_by_lane(field, lanes, half):
    """The fold with a lane axis (the kernel's plain version on CPU
    tensors), one root a lane, equals the fold of each lane alone, on the
    two halves of a tensor and on row-strided views."""
    rng = np.random.default_rng(lanes * half)
    ops = LimbOps(field, "cpu")
    values = from_numpy_limbs(_limbs(rng, (lanes, 2 * half), field), "cpu")
    roots = _roots(rng, (lanes,))
    tw = fold_twiddles(ops, 8)
    for lo, hi in ((slice(None, half), slice(half, None)), (slice(0, None, 2), slice(1, None, 2))):
        got = K.fri_fold(field, values[:, lo], values[:, hi], roots, tw, 2, 1)
        assert got.shape == (lanes, half, field.n16)
        for b in range(lanes):
            assert torch.equal(got[b], K.fri_fold(field, values[b, lo], values[b, hi], roots[b],
                                                  tw, 2, 1))


def test_fri_fold_with_lanes_equals_pallas_interpret_lane_by_lane():
    """Against the JAX package's Pallas fold in interpret mode, lane by
    lane (its tiles take half a multiple of 32 x 128 rows), given the
    twiddles and the challenge each root draws."""
    rng = np.random.default_rng(48)
    lanes, half, log_domain = 2, 4096, 14
    ops = LimbOps(F_STARK, "cpu")
    values = _limbs(rng, (lanes, 2 * half), F_STARK)
    roots = _roots(rng, (lanes,))
    tw = fold_twiddles(ops, log_domain)
    got = K.fri_fold(F_STARK, from_numpy_limbs(values[:, :half], "cpu"),
                     from_numpy_limbs(values[:, half:], "cpu"), roots, tw, 2)
    w = to_numpy_limbs(K.fold_twiddles_plain(F_STARK, tw, half, 2))
    c_scaled = to_numpy_limbs(ops.mul(K.fold_challenge_plain(F_STARK, roots), ops.two_inv_m))
    inv2 = to_numpy_limbs(ops.two_inv_m)
    for b in range(lanes):
        want = pallas_fri_fold(JF_STARK, jnp.asarray(values[b, :half]),
                               jnp.asarray(values[b, half:]), jnp.asarray(w),
                               jnp.asarray(c_scaled[b]), jnp.asarray(inv2), interpret=True)
        assert np.array_equal(to_numpy_limbs(got[b]), np.asarray(want))


def test_fri_fold_rejects_mismatched_lanes():
    ops = LimbOps(F_STARK, "cpu")
    v = ops.encode([list(range(8)), list(range(8, 16))])  # (2, 8, n16)
    roots = torch.zeros(2, 8, dtype=torch.int32)
    tw = fold_twiddles(ops, 4)
    with pytest.raises(ValueError):  # one root for two lanes
        K.fri_fold(F_STARK, v[:, :4], v[:, 4:], roots[0], tw, 1)
    with pytest.raises(ValueError):  # three roots for two lanes
        K.fri_fold(F_STARK, v[:, :4], v[:, 4:], torch.zeros(3, 8, dtype=torch.int32),
                   tw, 1)


@pytest.mark.parametrize("field", [F_STARK, F257], ids=lambda f: f.name)
def test_batched_tree_equals_per_lane_trees(field):
    rng = np.random.default_rng(49)
    leaves = from_numpy_limbs(_limbs(rng, (3, 32), field), "cpu")
    batch = MerkleTree.create(leaves, field)
    singles = [MerkleTree.create(leaves[b], field) for b in range(3)]
    assert batch.lanes == 3 and batch.root_digest().shape == (3, 8)
    assert batch.get_roots() == fetch_roots(singles)
    assert len(set(batch.get_roots())) == 3
    idx = torch.tensor([[1, 30, 7], [0, 0, 31], [16, 2, 9]])
    paths = batch.path_digests(idx)
    assert paths.shape == (5, 3, 3, 8)
    for b, tree in enumerate(singles):
        assert torch.equal(paths[:, b], tree.path_digests(idx[b]))
        lane = batch.lane(b)
        assert lane.get_root() == tree.get_root()
        assert lane.get_path(idx[b, 0].item()) == tree.get_path(idx[b, 0].item())
    with pytest.raises(ValueError):
        batch.path_digests(idx[0])
    with pytest.raises(ValueError):
        batch.get_root()
