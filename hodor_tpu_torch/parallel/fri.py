"""The FRI ladder on the ranks' row blocks (the mesh form of
fri.fri.fri_chain; the JAX package hands its jitted ladder h1 and h2
row-sharded, hodor_tpu/prover.py:324).

A fold pairs rows j and j + K/2 of a round's K values. Rank order[k]
holds natural block k of K/W rows, so block k (k < W/2) pairs with block
k + W/2. Their owners trade half a block (one all_to_all_v): the lo owner
keeps the first halves and folds output rows [k K/W, k K/W + K/2W), the
natural block 2k of the next round; the hi owner the second halves,
block 2k + 1. Each round moves N/2W rows a rank, N/W over a ladder,
where gathering the layer moves N (W - 1)/W. The blocks of the next
round lie in an owner order (`fold_order`): after one round from the
natural order rank r holds block 2r and rank r + W/2 block 2r + 1.

Each sharded layer is committed as a ShardedMerkleTree over the blocks in
that order, and the next fold draws its challenge from the replicated
root on the device, as on one device: the ladder adds no host fetch.
Layer 0 is always sharded (DEEP leaves h1 and h2 so). From the first
folded layer whose block has fewer than TAIL_ROWS rows on, the ladder
gathers once and finishes whole on every rank with fri_chain and its
final intt; a ladder that is sharded to its last layer gathers that
layer for the intt.
"""

from __future__ import annotations

from ..fri.fri import fold_pair, fold_twiddles, fri_chain
from ..field.limbs import from_numpy_limbs
from ..merkle.tree import MerkleTree
from ..ntt import intt
from ..profiling import span
from . import all_to_all_v, gather_rows, local_rows
from .multihost import ShardedMerkleTree

# a folded layer whose block has fewer rows than this is gathered: small
# enough that the 32-row goldens take sharded rounds at W = 4 (h1's blocks
# run 128, 64, 32, 16 rows before the tail)
TAIL_ROWS = 16


def fold_order(order):
    """The owner order of the blocks a fold gives from blocks in `order`:
    block 2k on the owner of block k, block 2k + 1 on that of k + W/2."""
    half = len(order) // 2
    return tuple(rank for k in range(half) for rank in (order[k], order[k + half]))


def ladder_orders(n: int, w: int, num_steps: int):
    """The owner order of each layer of a ladder over N rows on W ranks
    (layer 0 first), None for a layer held whole: every layer on one rank,
    the tail from the first folded layer of fewer than TAIL_ROWS rows a
    block on more."""
    if w == 1:
        return [None] * (num_steps + 1)
    orders, order = [], tuple(range(w))
    for i in range(num_steps + 1):
        if i and (n >> i) // w < TAIL_ROWS:
            return orders + [None] * (num_steps + 1 - i)
        orders.append(order)
        order = fold_order(order)
    return orders


def fold_block(ops, block, order, root, stride: int, log_domain: int, mesh):
    """One fold round on row blocks. block: this rank's (K/W, L) block of
    the round's values, natural block order.index(rank); root: the (8,)
    root digest the round's challenge is drawn from, the same on every
    rank. Returns this rank's (K/2W, L) block of the folded values, in the
    owner order fold_order(order)."""
    half = mesh.size() // 2
    b = block.shape[-2]
    k = order.index(mesh.get_local_rank())
    keep_lo = k < half
    peer = order[k + half] if keep_lo else order[k - half]
    keep, give = (block[:b // 2], block[b // 2:]) if keep_lo else (block[b // 2:], block[:b // 2])
    splits = [b // 2 if rank == peer else 0 for rank in range(mesh.size())]
    got = all_to_all_v(give, splits, splits, mesh)
    lo, hi = (keep, got) if keep_lo else (got, keep)
    first = k * b if keep_lo else (k - half) * b + b // 2
    return fold_pair(ops, lo, hi, root, stride, log_domain, first)


def sharded_fri_chain(ops, block, num_steps: int, log_domain: int, mesh):
    """fri_chain on this rank's (N/W, L) block of the l0 values, W > 1.
    Returns (trees, intermediate values, final coefficients): the trees of
    the sharded layers ShardedMerkleTrees over this rank's blocks (the
    values of those layers), the tail's MerkleTrees over whole values, and
    the final coefficients whole, on every rank."""
    orders = ladder_orders(block.shape[-2] * mesh.size(), mesh.size(), num_steps)
    fold_twiddles(ops, log_domain)  # built here, if at all: no round builds a table
    values, trees, intermediate = block, [], []
    for i, order in enumerate(orders):
        if order is None:  # the tail: gather once, finish whole
            whole = gather_rows(values, mesh, fold_order(orders[i - 1]))
            tail_trees, tail_values, coeffs = fri_chain(ops, whole, num_steps - i, log_domain,
                                                        first_round=i)
            return trees + tail_trees, intermediate[:-1] + [whole] + tail_values, coeffs
        with span("merkle.commit"):
            trees.append(ShardedMerkleTree.create(values, ops.field, mesh, order))
        if i == num_steps:
            break
        values = fold_block(ops, values, order, trees[-1].root_digest(), 1 << i, log_domain,
                            mesh)
        intermediate.append(values)
    return trees, intermediate, intt(ops, gather_rows(values, mesh, orders[-1]))


def ladder_from_layers(ops, block, layers, mesh=None):
    """A ladder's trees and intermediate values rebuilt from its saved
    layers, laid out as run_ladders lays them out: block is this rank's
    row block of the l0 values (all of them on one device), layers the
    whole (K, n16) uint32 arrays of the later layers on the host (a
    checkpoint's). Each rank moves only its rows of a sharded layer to its
    device. Returns (trees, intermediate values)."""
    w = 1 if mesh is None else mesh.size()
    orders = ladder_orders(block.shape[-2] * w, w, len(layers))
    values = [block] + [from_numpy_limbs(v if order is None else local_rows(v, mesh, order),
                                         block.device)
                        for v, order in zip(layers, orders[1:])]
    trees = [MerkleTree.create(v, ops.field) if order is None else
             ShardedMerkleTree.create(v, ops.field, mesh, order)
             for v, order in zip(values, orders)]
    return trees, values[1:]
