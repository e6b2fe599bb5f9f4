"""The FRI ladder on row blocks (hodor_tpu_torch.parallel.fri, run by
fri.fri.run_ladders under a mesh) on gloo ranks spawned on the CPU,
against one device's ladder (fri_chain through run_ladders) on the same
seeded (N, n16) values, tolerance 0: at W = 2 and 4 the roots, the
challenges, every layer's values (the sharded layers gathered back to
natural order), the final coefficients and the query openings of every
round, over F_STARK and F257, FRI to a constant and to degree 4, N from
a ladder whose folded layers are all in the tail (8 rows: blocks of 2
rows folded to 1 at W = 4) up to 2^10 rows. Each rank's l0 block is
(N/W, n16), the number of sharded layers is the one TAIL_ROWS gives, a
ladder sharded to its last layer gathers only that layer, and a prove's
FRI stage records its exchanges. The golden's own FRI stage takes
sharded rounds and the tail: counted on every rank by wrapping
fold_block and fri_chain.

Each W is one spawn of W ranks that runs every case; the ranks import
this module."""

import os

import numpy as np
import pytest

from hodor_tpu_torch import air
from hodor_tpu_torch import parallel as par
from hodor_tpu_torch.domain import log2_floor
from hodor_tpu_torch.field import F257, F_STARK
from hodor_tpu_torch.field.limbs import LimbOps, to_numpy_limbs
from hodor_tpu_torch.fri import NaiveFriIop
from hodor_tpu_torch.fri.fri import gather_chain_queries
from hodor_tpu_torch.models import VDF
from hodor_tpu_torch.parallel import fri as pfri
from hodor_tpu_torch.parallel.multihost import ShardedMerkleTree
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools.dryrun import run_ranks

FIELDS = {"F_STARK": F_STARK, "F257": F257}
WORLDS = [2, 4]
# (field, log2 N, lde factor, FRI final degree + 1)
CASES = [("F_STARK", 3, 2, 1), ("F257", 4, 4, 1), ("F257", 6, 16, 1), ("F257", 8, 16, 4),
         ("F_STARK", 9, 16, 1), ("F_STARK", 10, 8, 4), ("F_STARK", 10, 16, 1)]
N_QUERIES = 3


def _golden(name):
    with open(os.path.join(os.path.dirname(__file__), "golden", f"{name}.proof"), "rb") as f:
        return f.read()


def _values(p: int, count: int, seed: int):
    words = np.random.default_rng(seed).integers(0, 1 << 62, size=(count, 5), dtype=np.int64)
    return [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]


def _layers(proto, l0, mesh):
    """Every layer's values, whole: the sharded ones gathered back to
    natural order."""
    trees = [proto.l0_commitment] + proto.intermediate_commitments
    out = []
    for tree, v in zip(trees, [l0] + proto.intermediate_values):
        if isinstance(tree, ShardedMerkleTree):
            v = par.gather_rows(v, mesh, tree.order)
        out.append(to_numpy_limbs(v))
    return out


def _ladder(ops, whole, case, mesh):
    """One ladder over `whole`, under the mesh on this rank's block (mesh
    not None) or on one device: its prototype's roots, challenges, final
    coefficients, whole layers, openings at N_QUERIES indices and, under
    the mesh, the layout."""
    _, log_n, lde_factor, out_deg = case
    l0 = whole if mesh is None else par.local_rows(whole, mesh)
    (proto,) = NaiveFriIop.proofs_from_ldes(ops, [l0], lde_factor, out_deg, mesh)
    idx = np.random.default_rng(log_n).integers(0, 1 << log_n, size=N_QUERIES).tolist()
    openings = []
    for x in idx:
        _, _, chain_data, idx_arrays = NaiveFriIop.query_plan(proto, l0, x)
        openings.append([(to_numpy_limbs(v), s.numpy())
                         for v, s in gather_chain_queries(chain_data, idx_arrays)])
    trees = [proto.l0_commitment] + proto.intermediate_commitments
    return {"roots": proto.get_roots(), "challenges": proto.challenges,
            "final": proto.final_coefficients, "layers": _layers(proto, l0, mesh),
            "openings": openings,
            "sharded": [isinstance(t, ShardedMerkleTree) for t in trees],
            "l0_block": tuple(l0.shape) if mesh is not None else None}


def _counting(mesh, device):
    """The golden vdf_fstark_t32 under the mesh with fold_block and the
    tail's fri_chain counted: (proof bytes, sharded folds, tail chains and
    their rounds, the FRI stage's exchanges)."""
    counts = {"folds": 0, "tails": 0, "tail_rounds": 0}
    fold_block, fri_chain = pfri.fold_block, pfri.fri_chain

    def counted_fold(*args):
        counts["folds"] += 1
        return fold_block(*args)

    def counted_tail(ops, values, num_steps, log_domain, first_round=0):
        counts["tails"] += 1
        counts["tail_rounds"] += num_steps
        return fri_chain(ops, values, num_steps, log_domain, first_round=first_round)

    pfri.fold_block, pfri.fri_chain = counted_fold, counted_tail
    try:
        witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
        prover = Prover(props.clone(), 16, 1, device=device, mesh=mesh)
        proof = serialize_proof(prover.prove(witness), F_STARK)
    finally:
        pfri.fold_block, pfri.fri_chain = fold_block, fri_chain
    return proof, counts, prover.last_exchanges["fri_h1+h2"]


def _rank_ladders(mesh, device):
    out = {}
    for i, case in enumerate(CASES):
        ops = LimbOps(FIELDS[case[0]], device)
        whole = ops.encode(_values(ops.field.p, 1 << case[1], i))
        out[case] = (_ladder(ops, whole, case, mesh), _ladder(ops, whole, case, None))
    fib = air.Fibonacci(F257, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    witness, props = tracer.into_arp()
    prover = Prover(props.clone(), 16, 1, device=device, mesh=mesh)
    out["fib_f257"] = (serialize_proof(prover.prove(witness), F257),
                       prover.last_exchanges["fri_h1+h2"])
    out["golden"] = _counting(mesh, device)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    cache = {}

    def get(w):
        if w not in cache:
            rdv = tmp_path_factory.mktemp(f"rendezvous_w{w}") / "store"
            cache[w] = run_ranks(_rank_ladders, w, device="cpu", backend="gloo",
                                 init_method=f"file://{rdv}", timeout=180)
        return cache[w]

    return get


def _expected_sharded(case, w):
    """Layer 0 and every folded layer of at least TAIL_ROWS rows a block
    (while the ladder lasts) are sharded."""
    _, log_n, lde_factor, out_deg = case
    steps = log2_floor((1 << log_n) // lde_factor // out_deg)
    return [i == 0 or (1 << (log_n - i)) // w >= pfri.TAIL_ROWS for i in range(steps + 1)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-N{1 << c[1]}-lde{c[2]}-deg{c[3]}")
@pytest.mark.parametrize("w", WORLDS)
def test_sharded_ladder_equals_one_device(spawned, w, case):
    n16 = FIELDS[case[0]].n16
    for r, ranks in enumerate(spawned(w)):
        mesh_run, alone = ranks[case]
        for key in ("roots", "challenges", "final"):
            assert mesh_run[key] == alone[key], f"rank {r}: {key}"
        assert len(mesh_run["layers"]) == len(alone["layers"])
        for i, (a, b) in enumerate(zip(mesh_run["layers"], alone["layers"])):
            assert np.array_equal(a, b), f"rank {r}: layer {i}"
        for q, (got, want) in enumerate(zip(mesh_run["openings"], alone["openings"])):
            assert len(got) == len(want) == len(alone["layers"])
            for k, ((v, s), (v1, s1)) in enumerate(zip(got, want)):
                assert np.array_equal(v, v1) and np.array_equal(s, s1), f"rank {r}: q{q} round {k}"
        assert mesh_run["l0_block"] == ((1 << case[1]) // w, n16)
        assert mesh_run["sharded"] == _expected_sharded(case, w)
        assert not any(alone["sharded"])


@pytest.mark.parametrize("w", WORLDS)
def test_tail_alone_and_sharded_to_the_end(spawned, w):
    """8 rows: only l0 is sharded (its blocks of 8 / W rows fold straight
    into the tail); 256 rows to degree 4 at W = 4: every layer is sharded,
    the last one (64 rows, blocks of 16) gathered for the final
    coefficients alone."""
    ranks = spawned(w)[0]
    assert ranks[CASES[0]][0]["sharded"] == [True, False, False]
    if w == 4:
        assert ranks[("F257", 8, 16, 4)][0]["sharded"] == [True, True, True]


@pytest.mark.parametrize("w", WORLDS)
def test_golden_takes_sharded_rounds_and_the_tail(spawned, w):
    """vdf_fstark_t32: h1 has 512 rows, h2 1024, five and six folds. At
    W = 4 h1's blocks run 128, 64, 32, 16 rows, four sharded folds (the
    last into the tail's first layer, blocks of 8) and one tail round; h2's
    256 to 16, five and one. The proof is the golden on every rank."""
    data = _golden("vdf_fstark_t32")
    # sharded folds per ladder (h1, h2): one from every sharded layer
    sharded = {2: (5, 6), 4: (4, 5)}[w]
    for r, ranks in enumerate(spawned(w)):
        proof, counts, exchanges = ranks["golden"]
        assert proof == data, f"rank {r}"
        assert counts == {"folds": sum(sharded), "tails": 2,
                          "tail_rounds": 5 + 6 - sum(sharded)}, f"rank {r}"
        assert exchanges["all_to_all"]["calls"] == sum(sharded)


@pytest.mark.parametrize("w", WORLDS)
def test_mesh_prove_records_fri_exchanges(spawned, w):
    data = _golden("fib_f257")
    for r, ranks in enumerate(spawned(w)):
        proof, exchanges = ranks["fib_f257"]
        assert proof == data, f"rank {r}"
        assert exchanges["all_to_all"]["calls"] > 0 and exchanges["all_gather"]["calls"] > 0
        assert exchanges["all_to_all"]["bytes"] > 0


def test_fold_order_and_ladder_orders():
    """After one round from the natural order rank r holds block 2r and
    rank r + W/2 block 2r + 1; one rank holds every layer whole."""
    assert pfri.fold_order((0, 1, 2, 3)) == (0, 2, 1, 3)
    assert pfri.fold_order((0, 2, 1, 3)) == (0, 1, 2, 3)
    assert pfri.fold_order((0, 1)) == (0, 1)
    assert pfri.ladder_orders(512, 4, 5) == [(0, 1, 2, 3), (0, 2, 1, 3), (0, 1, 2, 3),
                                             (0, 2, 1, 3), None, None]
    assert pfri.ladder_orders(512, 1, 5) == [None] * 6
    assert pfri.ladder_orders(8, 4, 2) == [(0, 1, 2, 3), None, None]
    assert pfri.TAIL_ROWS == 16
