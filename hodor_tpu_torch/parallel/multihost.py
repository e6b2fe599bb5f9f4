"""Multi-process distribution over torch.distributed: joining a job, the
mesh over its ranks, host <-> device plumbing, and Merkle trees whose
leaves are row blocks (the port of hodor_tpu/parallel/multihost.py).

The port is multi-process by construction: one process per rank, each
with one device, whether the ranks share a host or not. Every process
runs the same program, and every value the host sees is replicated, so
every rank derives the same Fiat-Shamir transcript (the SPMD-controller
style).

- `init_multihost`: `torch.distributed.init_process_group`, with the
  backend and the rank's device named by the caller (NCCL with one card
  per rank, gloo across CPU processes or ranks sharing a card);
- `global_mesh`, `replicated`, `row_sharded`, `host_value`;
- `ShardedMerkleTree` and `sharded_merkle_root`: a Merkle tree over
  leaves held as row blocks. A block of N/W leaves, a power of two, is a
  complete subtree of the reference's heap layout
  (src/iop/blake2s_trivial_iop.rs:131-219), so each rank hashes its
  subtree with no exchange, one all_gather brings the W subtree roots
  (8 words each), and every rank hashes the top log2 W levels: the root
  is MerkleTree.create's. The blocks may lie on the ranks in an owner
  order (the FRI ladder's, parallel/fri.py): the top levels then take the
  subtree roots in natural order. `sharded_openings` opens such trees at
  query indices with one all_gather for all of them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..field.field import Field
from ..field.limbs import LimbOps
from ..merkle.blake2s import digest_to_bytes, hash_block
from ..merkle.tree import MerkleTree, take_rows
from . import all_gather, make_mesh

INIT_SCHEMES = ("tcp://", "file://")


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   backend: str, device) -> None:
    """Join this process to a torch.distributed job as rank `process_id`
    of `num_processes`. coordinator_address: "tcp://host:port" or
    "file:///path" (the rendezvous); backend: "nccl" or "gloo"; device:
    this rank's device, made the current CUDA device where it is one (so
    NCCL and the mesh bind to it)."""
    if not coordinator_address.startswith(INIT_SCHEMES):
        raise ValueError(f"coordinator_address must start with one of {INIT_SCHEMES}, got "
                         f"{coordinator_address!r}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def global_mesh(device="cuda"):
    """The 1-D mesh ("shards",) over every rank of the job."""
    return make_mesh(None, device)


def _device(mesh) -> torch.device:
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def replicated(mesh, host_array) -> torch.Tensor:
    """A host numpy array, the same on every rank (from a shared seed or
    the replayed transcript) -> the whole array on this rank's device."""
    return torch.from_numpy(np.ascontiguousarray(host_array)).to(_device(mesh))


def row_sharded(mesh, host_array) -> torch.Tensor:
    """A host numpy array, the same on every rank -> this rank's row
    block of axis 0 on its device; only those rows are copied."""
    arr = np.asarray(host_array)
    n = arr.shape[0] // mesh.size()
    r = mesh.get_local_rank()
    return torch.from_numpy(np.ascontiguousarray(arr[r * n:(r + 1) * n])).to(_device(mesh))


def host_value(t: torch.Tensor) -> np.ndarray:
    """A replicated tensor -> numpy on the host (the same on every rank)."""
    return t.detach().cpu().numpy()


def _top_levels(roots):
    """(..., W, 8) subtree roots -> [roots, (..., W/2, 8), ..., (..., 1, 8)]."""
    levels = [roots]
    while levels[-1].shape[-2] > 1:
        cur = levels[-1]
        levels.append(hash_block(cur.reshape(cur.shape[:-2] + (cur.shape[-2] // 2, 16)), 64))
    return levels


class ShardedMerkleTree:
    """A Merkle tree over N leaves held as row blocks: `local`, this
    rank's MerkleTree over its N/W leaves (up to their subtree root), and
    `top`, the log2 W levels above it, replicated: top[0] the (W, 8)
    subtree roots in natural block order, top[-1] the (1, 8) root.
    `order`: the owner order, order[k] the rank that holds natural block
    k (rank k unless the tree was made with another)."""

    lanes = None  # one tree (merkle.tree.fetch_roots reads it)

    def __init__(self, local: MerkleTree, top, mesh, field: Field, order):
        self.local = local
        self.top = top
        self.mesh = mesh
        self.field = field
        self.order = order
        self.size = local.size * mesh.size()
        self._root_bytes = None

    @staticmethod
    def create_many(leaf_blocks, field: Field, mesh, order=None) -> List["ShardedMerkleTree"]:
        """leaf_blocks: (B, N/W, n16), this rank's leaves of B trees. The
        B local trees are built together (one launch a level) and one
        all_gather brings every tree's subtree roots. order: the owner
        order of the blocks (natural by default)."""
        order = tuple(range(mesh.size())) if order is None else tuple(order)
        local = MerkleTree.create(leaf_blocks, field)
        roots = all_gather(local.root_digest(), mesh)[list(order)]  # (W, B, 8), natural order
        top = _top_levels(roots.movedim(0, 1))  # per level (B, W/2^k, 8)
        return [ShardedMerkleTree(local.lane(b), [level[b] for level in top], mesh, field, order)
                for b in range(leaf_blocks.shape[0])]

    @staticmethod
    def create(leaf_block, field: Field, mesh, order=None) -> "ShardedMerkleTree":
        """leaf_block: (N/W, n16), this rank's leaves."""
        return ShardedMerkleTree.create_many(leaf_block[None], field, mesh, order)[0]

    def root_digest(self):
        """(8,) int32 root digest on the device, the same on every rank."""
        return self.top[-1][0]

    def get_root(self) -> bytes:
        if self._root_bytes is None:
            self._root_bytes = digest_to_bytes(self.root_digest())
        return self._root_bytes


def sharded_openings(entries, mesh):
    """Openings of sharded trees at global query indices, every rank the
    same result, on the device (fri.gather_chain_queries fetches them
    with the rest of a prove's openings). entries: list of (ShardedMerkleTree,
    this rank's (N/W, L) block of its committed values, (Q,) int64 index
    tensor). The owner of index x (rank order[x // (N/W)]) gives the
    value and the siblings inside its subtree; the replicated top levels
    give the log2 W siblings above. Every rank's part of every entry
    travels in one all_gather and is picked by owner. Returns per entry
    (values (Q, L), siblings (log2 N, Q, 8))."""
    r = mesh.get_local_rank()
    parts, layout, where = [], [], []
    for tree, vals, idx in entries:
        n = tree.local.size
        block = idx // n  # natural block of each index
        owner = torch.tensor(tree.order, dtype=idx.dtype, device=idx.device)[block]
        mine = owner == r
        local_idx = torch.where(mine, idx - block * n, torch.zeros_like(idx))
        v = take_rows(vals, local_idx) * mine[:, None]
        s = tree.local.path_digests(local_idx, vals) * mine[None, :, None]
        parts += [v.reshape(-1), s.reshape(-1)]
        layout.append((v.shape, s.shape))
        where.append((block, owner))
    got = all_gather(torch.cat(parts), mesh)  # (W, total): every rank's parts
    out, at = [], 0
    for (tree, _, idx), (v_shape, s_shape), (block, owner) in zip(entries, layout, where):
        q = torch.arange(idx.shape[0], device=idx.device)
        nv, ns = int(np.prod(v_shape)), int(np.prod(s_shape))
        v = got[:, at:at + nv].reshape((-1,) + tuple(v_shape))[owner, q]  # (Q, L)
        s = got[:, at + nv:at + nv + ns].reshape((-1,) + tuple(s_shape))[owner, :, q]  # (Q, d, 8)
        at += nv + ns
        upper = [level[(block >> k) ^ 1] for k, level in enumerate(tree.top[:-1])]
        out.append((v, torch.cat([s.movedim(0, 1)] + [u[None] for u in upper], dim=0)))
    return out


def sharded_merkle_root(ops: LimbOps, leaf_limbs, mesh):
    """Merkle root of (N, n16) Montgomery leaves held as row blocks:
    leaf_limbs is this rank's (N/W, n16) block. Subtree hashing with no
    exchange, one all_gather of the W subtree roots, the top levels on
    every rank. Returns the replicated (8,) int32 digest, equal to
    MerkleTree.create of the whole array's."""
    return ShardedMerkleTree.create(leaf_limbs, ops.field, mesh).root_digest()


def root_digest_bytes(digest_words) -> bytes:
    """(8,) digest words -> the 32-byte root (little-endian words, as
    merkle.blake2s.digest_to_bytes)."""
    return digest_to_bytes(digest_words)
