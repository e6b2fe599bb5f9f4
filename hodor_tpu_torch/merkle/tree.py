"""Merkle tree build / query / verify over Blake2s digests.

Reference: Blake2sIopTree (src/iop/blake2s_trivial_iop.rs:113-290) with
the TrivialCombiner (natural index == tree index, leaf pairs (2i, 2i+1),
src/iop/trivial_coset_combiner.rs). Levels are built bottom-up with one
hashing launch each; a level's (N/2, 16) node messages are the level
below read as pairs, so no copy is made between levels.

A tree may carry a leading lane axis, one lane per proof of a batch
(Prover.prove_batch): leaves (B, N, n16) are hashed in one launch, and so
is each level of all lanes, read as (B N / 2^k, 16) pairs. N is a power of
two of at least 2, so no pair straddles two lanes, and the build stops at
the B lane roots.

A tree of at least TREE_DROP_MIN leaves (a lane's) is dropped: its build
lets each level go once the next is built, and it keeps only its root
digest, its size and its lanes (hodor_tpu's tree_drop_min). Its openings
hash the committed values again, keeping only the siblings they need
(`rebuilt_path_digests`), so its resident bytes are those of its root.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..field.field import Field
from ..field.limbs import fetch_together
from ..profiling import form_counts
from .blake2s import blake2s_keyed, digest_to_bytes, hash_block, hash_leaf_limbs

# Trees over at least this many leaves (a lane's) are dropped. Above every
# tree of a 2^20-row prove at lde 16 (2^25 leaves), at the f, g, h1 and
# h2 trees of a 2^22-row one (2^26 and 2^27 leaves): set from the memory
# profile of those proves on an H100 80GB HBM3 (tools/memory_profile.py,
# PERF.md §6).
TREE_DROP_MIN = 1 << 26


def next_level(cur):
    """(..., M, 8) digests -> (..., M/2, 8) parents: the pairs read in
    place as (..., M/2, 16) words, one launch for all leading dims."""
    return hash_block(cur.reshape(cur.shape[:-2] + (cur.shape[-2] // 2, 16)), 64)


def build_levels(leaf_limbs):
    """leaf_limbs (..., N, n16) -> (leaf_hashes (..., N, 8), levels):
    levels[0] is the first internal level (..., N/2, 8), levels[-1] the
    roots (..., 1, 8). One launch per level for all leading dims."""
    leaf_hashes = hash_leaf_limbs(leaf_limbs)
    levels = []
    cur = leaf_hashes
    while cur.shape[-2] > 1:
        cur = next_level(cur)
        levels.append(cur)
    return leaf_hashes, levels


def build_root(leaf_limbs):
    """The roots (..., 1, 8) of leaf_limbs (..., N, n16), each level let go
    once the next is built."""
    cur = hash_leaf_limbs(leaf_limbs)
    while cur.shape[-2] > 1:
        cur = next_level(cur)
    return cur


def rebuilt_path_digests(leaf_limbs, idx):
    """MerkleTree.path_digests(idx) of the tree over leaf_limbs, hashed
    again: the leaves, then each level in turn, each let go once the next
    is built, only the siblings of idx kept. leaf_limbs (N, n16) with idx
    (Q,), or (B, N, n16) with idx (B, Q) -> (depth, [B,] Q, 8)."""
    cur = hash_leaf_limbs(leaf_limbs)
    sibs = [take_rows(cur, idx ^ 1)]
    idx = idx >> 1
    while cur.shape[-2] > 2:
        cur = next_level(cur)
        sibs.append(take_rows(cur, idx ^ 1))
        idx = idx >> 1
    return torch.stack(sibs, dim=0)


def take_rows(t, idx):
    """Rows idx of t: t (N, C) with idx (Q,) -> (Q, C), or t (B, N, C)
    with idx (B, Q) -> (B, Q, C), lane b's rows from lane b (one index
    op over all lanes; t may be a strided view, nothing is copied but the
    rows taken)."""
    if t.dim() == 2:
        return t[idx]
    lanes = torch.arange(t.shape[0], dtype=idx.dtype, device=idx.device)[:, None]
    return t[lanes, idx]


@dataclasses.dataclass
class IopQuery:
    """A Merkle opening (reference TrivialBlake2sIopQuery,
    src/iop/blake2s_trivial_iop.rs:349-374). natural == tree index."""

    index: int
    value: int  # canonical field int
    path: List[bytes]

    @property
    def natural_index(self) -> int:
        return self.index

    @property
    def tree_index(self) -> int:
        return self.index


class MerkleTree:
    """Device-built Blake2s commitment tree over field-element leaves, one
    tree or a batch of B trees of equal size (a leading lane axis). A
    dropped tree holds its root digest alone (leaf_hashes and levels
    None)."""

    def __init__(self, root, field: Field, size: int, leaf_hashes=None, levels=None):
        self.field = field
        self.root = root  # (8,) or (B, 8) int32 digest on the device
        self.size = size
        self.lanes = int(root.shape[0]) if root.dim() == 2 else None
        self.leaf_hashes = leaf_hashes  # (N, 8) or (B, N, 8); None once dropped
        self.levels = levels  # bottom-up internal levels; None once dropped
        self._root_bytes = None  # bytes, or a list of them per lane

    @staticmethod
    def create(leaf_limbs, field: Field) -> "MerkleTree":
        """leaf_limbs: (N, n16) Montgomery limbs (N a power of two), or
        (B, N, n16) for a batch of B trees built together; dropped at
        TREE_DROP_MIN leaves and up."""
        if leaf_limbs.dim() not in (2, 3):
            raise ValueError(f"expected (N, n16) or (B, N, n16) leaves, got "
                             f"{tuple(leaf_limbs.shape)}")
        n = leaf_limbs.shape[-2]
        if n & (n - 1) or n < 2:
            raise ValueError(f"a tree needs a power-of-two leaf count >= 2, got {n}")
        if n >= TREE_DROP_MIN:
            form_counts["trees_dropped"] += 1
            return MerkleTree(build_root(leaf_limbs)[..., 0, :], field, n)
        leaf_hashes, levels = build_levels(leaf_limbs)
        return MerkleTree(levels[-1][..., 0, :], field, n, leaf_hashes, levels)

    @property
    def dropped(self) -> bool:
        return self.leaf_hashes is None

    def drop(self) -> None:
        """Let the leaf hashes and levels go; the root, size and lanes stay,
        and openings hash the committed values again."""
        self.leaf_hashes = self.levels = None

    def root_digest(self):
        """(8,) int32 root digest on the device; (B, 8) for a batch."""
        return self.root

    def get_root(self) -> bytes:
        """The root's 32 bytes (one tree; a batch gives `get_roots`)."""
        if self.lanes is not None:
            raise ValueError("a batch of trees has one root per lane: get_roots()")
        if self._root_bytes is None:
            self._root_bytes = digest_to_bytes(self.root_digest())
        return self._root_bytes

    def get_roots(self) -> List[bytes]:
        """Each lane's root bytes (a batch of trees), fetched in one copy."""
        if self.lanes is None:
            return [self.get_root()]
        if self._root_bytes is None:
            fetch_roots([self])
        return self._root_bytes

    def lane(self, b: int) -> "MerkleTree":
        """Lane b of a batch as a tree of its own: views, no copy."""
        tree = MerkleTree(self.root[b], self.field, self.size)
        if not self.dropped:
            tree.leaf_hashes = self.leaf_hashes[b]
            tree.levels = [level[b] for level in self.levels]
        if self._root_bytes is not None:
            tree._root_bytes = self._root_bytes[b]
        return tree

    def get_challenge_scalar_from_root(self) -> int:
        """Root -> field challenge (encode_root_into_challenge,
        src/iop/blake2s_trivial_iop.rs:226-234: BE read + shave)."""
        return self.field.from_be_with_shave(self.get_root())

    def path_digests(self, idx, values=None):
        """idx (Q,) int64 tensor on the device -> (depth, Q, 8) sibling
        digests bottom-up: the pair leaf hash, then internal siblings up
        to the root's children (src/iop/blake2s_trivial_iop.rs:281-311).
        A batch takes idx (B, Q), lane b's indices into lane b's tree, and
        gives (depth, B, Q, 8), one index op per level for all lanes.
        values: the committed (..., N, n16) leaves, which a dropped tree
        hashes again (`rebuilt_path_digests`); a kept tree reads its
        levels."""
        if (idx.dim() == 2) != (self.lanes is not None):
            raise ValueError(f"indices {tuple(idx.shape)} do not fit a tree with lanes "
                             f"{self.lanes}")
        if self.dropped:
            if values is None:
                raise ValueError("a dropped tree opens from its committed values: "
                                 "path_digests(idx, values)")
            return rebuilt_path_digests(values, idx)
        sibs = [take_rows(self.leaf_hashes, idx ^ 1)]
        cur = idx >> 1
        for level in self.levels[:-1]:
            sibs.append(take_rows(level, cur ^ 1))
            cur = cur >> 1
        return torch.stack(sibs, dim=0)

    def get_path(self, tree_index: int, values=None) -> List[bytes]:
        """The sibling path of one leaf as bytes (values: as for
        path_digests)."""
        idx = torch.tensor([tree_index], dtype=torch.int64, device=self.root.device)
        sibs = self.path_digests(idx, values).cpu()
        return [digest_to_bytes(sibs[d, 0]) for d in range(sibs.shape[0])]

    def query(self, natural_index: int, leaf_values_canonical) -> IopQuery:
        """Produce an opening of a kept tree; leaf_values_canonical is a
        sequence of canonical ints (the committed vector)."""
        return IopQuery(
            index=natural_index,
            value=int(leaf_values_canonical[natural_index]),
            path=self.get_path(natural_index),
        )


def fetch_roots(trees: List[MerkleTree]) -> list:
    """Root bytes of several trees, fetched in one device-to-host copy;
    each tree keeps its root. A tree with lanes gives the list of its
    lanes' roots."""
    return keep_roots(trees, fetch_together([t.root_digest() for t in trees]))


def keep_roots(trees: List[MerkleTree], digests) -> list:
    """Each tree keeps the root bytes of its fetched root digest (a list
    per lane for a tree with lanes); returns them."""
    for tree, digest in zip(trees, digests):
        tree._root_bytes = (digest_to_bytes(digest) if tree.lanes is None
                            else [digest_to_bytes(d) for d in digest])
    return [tree._root_bytes for tree in trees]


def verify_path(root: bytes, leaf_value: int, path: List[bytes], tree_index: int,
                field: Field) -> bool:
    """Host path verification (reference Blake2sIopTree::verify,
    src/iop/blake2s_trivial_iop.rs:259-279): hash the leaf's 32-byte raw
    LE repr, then fold siblings left/right by index parity."""
    h = blake2s_keyed(field.raw_repr_le(leaf_value).ljust(32, b"\x00"))
    idx = tree_index
    for sibling in path:
        h = blake2s_keyed(h + sibling) if idx & 1 == 0 else blake2s_keyed(sibling + h)
        idx >>= 1
    return h == root


def encode_root_into_challenge(root: bytes, field: Field) -> int:
    return field.from_be_with_shave(root)
