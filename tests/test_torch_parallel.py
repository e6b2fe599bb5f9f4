"""The port's multi-device functions (hodor_tpu_torch.parallel and
parallel.multihost) on gloo ranks spawned on the CPU, held against
hodor_tpu.parallel's functions on make_mesh(W) of conftest's 8 virtual
CPU devices, tolerance 0: the four-step NTT in both forms, the inverse
and icoset transforms, the coset-split LDE with and without the coset
shift and the row-sharded coset LDE, at W = 2 and 4 over F_P63 and
F_STARK; the sharded Merkle root and openings against hodor_tpu's; the
collective counts of the worker's audit.

Each W is one spawn of W ranks that runs every case (each rank returns
its row blocks and its collective counts); the JAX references run in
this process meanwhile. The ranks import this module, so JAX is imported only
inside the references."""

import collections
import concurrent.futures

import numpy as np
import pytest
import torch

from hodor_tpu_torch import parallel as par
from hodor_tpu_torch.field import F_P63, F_STARK
from hodor_tpu_torch.field.limbs import LimbOps, to_numpy_limbs
from hodor_tpu_torch.parallel.multihost import ShardedMerkleTree, sharded_merkle_root, \
    sharded_openings
from hodor_tpu_torch.tools.dryrun import run_ranks

FIELDS = {"F_P63": F_P63, "F_STARK": F_STARK}
# fn, field, log2 of the output rows, lde factor, batch
Case = collections.namedtuple("Case", "fn field log_n factor batch", defaults=(1, 1))
CASES = {
    2: [Case("four_step_ntt", "F_P63", 11), Case("four_step_ntt", "F_STARK", 1),
        Case("four_step_intt", "F_STARK", 8), Case("sharded_icoset_ntt", "F_P63", 10),
        Case("sharded_lde", "F_STARK", 8, 8, 2), Case("sharded_lde_coset", "F_P63", 11, 4),
        Case("sharded_coset_lde_rows", "F_STARK", 8, 2, 2)],
    4: [Case("four_step_ntt", "F_STARK", 8), Case("four_step_ntt", "F_P63", 3),
        Case("four_step_intt", "F_P63", 11), Case("sharded_icoset_ntt", "F_STARK", 9),
        Case("sharded_lde", "F_P63", 11, 8, 2), Case("sharded_lde_coset", "F_STARK", 8, 4),
        Case("sharded_coset_lde_rows", "F_P63", 10, 2, 3),
        Case("sharded_coset_lde_rows", "F_STARK", 4, 2)],
}
# the a2a form where the rows a rank holds are at least W (JAX's condition)
MERKLE = {2: ("F_P63", 10), 4: ("F_STARK", 8)}
N_QUERIES = 6


def _values(p: int, count: int, seed: int):
    """`count` seeded canonical ints below p, the same in every process."""
    words = np.random.default_rng(seed).integers(0, 1 << 62, size=(count, 5), dtype=np.int64)
    return [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]


def _input(case, seed):
    """(canonical ints, shape): the transform's N points, or an LDE's
    (batch, T) coefficients."""
    p = FIELDS[case.field].p
    if case.fn.startswith(("four_step", "sharded_icoset")):
        shape = (1 << case.log_n,)
    else:
        shape = (case.batch, (1 << case.log_n) // case.factor)
    return _values(p, int(np.prod(shape)), seed), shape


def _port(case, ops, x, mesh):
    if case.fn == "four_step_ntt":
        return par.four_step_ntt(ops, par.local_rows(x, mesh), mesh)
    if case.fn == "four_step_intt":
        return par.four_step_intt(ops, par.local_rows(x, mesh), mesh)
    if case.fn == "sharded_icoset_ntt":
        return par.sharded_icoset_ntt(ops, par.local_rows(x, mesh), mesh)
    if case.fn == "sharded_coset_lde_rows":
        return par.sharded_coset_lde_rows(ops, x, case.factor, mesh)
    return par.sharded_lde(ops, x, case.factor, mesh, coset=case.fn == "sharded_lde_coset")


def _rank_cases(mesh, device, w):
    """One rank: every case of W, its row block of each output and the
    collectives of each call; the sharded tree's root and openings."""
    out = {}
    for i, case in enumerate(CASES[w]):
        ops = LimbOps(FIELDS[case.field], device)
        vals, shape = _input(case, i)
        x = ops.encode(vals).reshape(shape + (ops.n16,))
        before = par.collective_snapshot()
        block = _port(case, ops, x, mesh)
        calls = {k: v["calls"] for k, v in par.collectives_since(before).items()}
        out[i] = (to_numpy_limbs(block), calls)
    field_name, log_n = MERKLE[w]
    ops = LimbOps(FIELDS[field_name], device)
    leaves = par.local_rows(ops.encode(_values(ops.field.p, 1 << log_n, 99)), mesh)
    before = par.collective_snapshot()
    root = sharded_merkle_root(ops, leaves, mesh)
    root_calls = par.collectives_since(before)["all_gather"]["calls"]
    tree = ShardedMerkleTree.create(leaves, ops.field, mesh)
    idx = torch.as_tensor(_query_indices(log_n), dtype=torch.int64)
    before = par.collective_snapshot()
    (vals, sibs), = sharded_openings([(tree, leaves, idx)], mesh)
    open_calls = par.collectives_since(before)["all_gather"]["calls"]
    out["merkle"] = (bytes(par.multihost.root_digest_bytes(root)), tree.get_root(),
                     to_numpy_limbs(vals), sibs.numpy(), root_calls, open_calls)
    return out


def _query_indices(log_n):
    return np.random.default_rng(5).integers(0, 1 << log_n, size=N_QUERIES).tolist()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """W -> the W ranks' results: one spawn per W, both started at once in
    a background thread (one after the other) so that they run while
    this process compiles the JAX references."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {w: pool.submit(run_ranks, _rank_cases, w, (w,), device="cpu", backend="gloo",
                              init_method=f"file://{tmp_path_factory.mktemp(f'rdv{w}') / 'store'}",
                              timeout=180)
               for w in sorted(CASES)}
    yield lambda w: futures[w].result()
    pool.shutdown(wait=True)
    for f in futures.values():
        f.result()


def _jax_reference(case, w, seed):
    import jax

    import hodor_tpu.field as jfield
    from hodor_tpu import parallel as jpar

    jops = jfield.ops_for(getattr(jfield, case.field))
    vals, shape = _input(case, seed)
    x = jops.encode(vals).reshape(shape + (jops.field.n16,))
    mesh = jpar.make_mesh(w)
    fns = {
        "four_step_ntt": lambda a: jpar.four_step_ntt(jops, a, mesh),
        "four_step_intt": lambda a: jpar.four_step_intt(jops, a, mesh),
        "sharded_icoset_ntt": lambda a: jpar.sharded_icoset_ntt(jops, a, mesh),
        "sharded_lde": lambda a: jpar.sharded_lde(jops, a, case.factor, mesh),
        "sharded_lde_coset": lambda a: jpar.sharded_lde(jops, a, case.factor, mesh, coset=True),
        "sharded_coset_lde_rows": lambda a: jpar.sharded_coset_lde_rows(jops, a, case.factor,
                                                                        mesh),
    }
    return np.asarray(jax.device_get(jax.jit(fns[case.fn])(x)))


@pytest.mark.parametrize("w,i", [(w, i) for w in CASES for i in range(len(CASES[w]))],
                         ids=[f"W{w}-{c.fn}-{c.field}-2^{c.log_n}" for w in CASES for c in CASES[w]])
def test_parallel_function_matches_hodor_tpu(spawned, w, i):
    """Every rank's row block of the port's output is that block of
    hodor_tpu.parallel's output on the same inputs, bit for bit."""
    case = CASES[w][i]
    want = _jax_reference(case, w, i)
    blocks = [ranks[i][0] for ranks in spawned(w)]
    rows = want.shape[-2] // w
    for r, block in enumerate(blocks):
        assert block.shape == want[..., r * rows:(r + 1) * rows, :].shape
        np.testing.assert_array_equal(block, want[..., r * rows:(r + 1) * rows, :],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("w", sorted(CASES))
def test_collective_counts(spawned, w):
    """The worker's audit, on every rank: the four-step's all_to_all form
    makes 3 all_to_all and no all_gather, its gather form one all_gather,
    sharded_lde one all_to_all, the row-sharded coset LDE 3 all_to_all
    (a2a branch) and the icoset transform 3."""
    want = {"four_step_ntt": lambda c: (3, 0) if (1 << c.log_n) // w >= w else (0, 1),
            "four_step_intt": lambda c: (3, 0), "sharded_icoset_ntt": lambda c: (3, 0),
            "sharded_lde": lambda c: (1, 0), "sharded_lde_coset": lambda c: (1, 0),
            "sharded_coset_lde_rows":
                lambda c: (3, 0) if (1 << c.log_n) // c.factor // w >= w else (0, 1)}
    for ranks in spawned(w):
        for i, case in enumerate(CASES[w]):
            calls = ranks[i][1]
            assert (calls["all_to_all"], calls["all_gather"]) == want[case.fn](case), case


@pytest.mark.parametrize("w", sorted(MERKLE))
def test_sharded_merkle_root_and_openings_match_hodor_tpu(spawned, w):
    """The root of the sharded tree (one all_gather) equals
    hodor_tpu.parallel.multihost.sharded_merkle_root and
    MerkleTree.create(...).get_root() on the whole array, on every rank;
    the openings at seeded indices (one all_gather) equal hodor_tpu's
    values and paths."""
    import jax

    import hodor_tpu.field as jfield
    from hodor_tpu import parallel as jpar
    from hodor_tpu.merkle.tree import MerkleTree as JMerkleTree
    from hodor_tpu.parallel.multihost import root_digest_bytes as jroot_bytes
    from hodor_tpu.parallel.multihost import sharded_merkle_root as jsharded_root

    field_name, log_n = MERKLE[w]
    jops = jfield.ops_for(getattr(jfield, field_name))
    leaves = jops.encode(_values(jops.field.p, 1 << log_n, 99))
    mesh = jpar.make_mesh(w)
    want_sharded = jroot_bytes(jax.device_get(
        jax.jit(lambda x: jsharded_root(jops, x, mesh))(leaves)))
    jtree = JMerkleTree.create(leaves, jops.field)
    assert want_sharded == jtree.get_root()
    host = np.asarray(jax.device_get(leaves))
    for root, tree_root, vals, sibs, root_calls, open_calls in (r["merkle"] for r in spawned(w)):
        assert root == tree_root == want_sharded
        assert (root_calls, open_calls) == (1, 1)
        for q, x in enumerate(_query_indices(log_n)):
            np.testing.assert_array_equal(vals[q], host[x])
            assert [bytes(sibs[d, q].astype("<u4").tobytes()) for d in range(log_n)] == \
                jtree.get_path(x)
