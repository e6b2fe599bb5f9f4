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
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..field.field import Field
from ..field.limbs import fetch_together
from .blake2s import (
    blake2s_keyed,
    digest_to_bytes,
    hash_block,
    hash_leaves,
    limbs_to_leaf_words,
)


def build_levels(leaf_limbs):
    """leaf_limbs (..., N, n16) -> (leaf_hashes (..., N, 8), levels):
    levels[0] is the first internal level (..., N/2, 8), levels[-1] the
    roots (..., 1, 8). One launch per level for all leading dims."""
    leaf_hashes = hash_leaves(limbs_to_leaf_words(leaf_limbs))
    levels = []
    cur = leaf_hashes
    while cur.shape[-2] > 1:
        cur = hash_block(cur.reshape(cur.shape[:-2] + (cur.shape[-2] // 2, 16)), 64)
        levels.append(cur)
    return leaf_hashes, levels


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
    tree or a batch of B trees of equal size (a leading lane axis)."""

    def __init__(self, leaf_hashes, levels, field: Field):
        self.field = field
        self.leaf_hashes = leaf_hashes  # (N, 8) or (B, N, 8) int32 on the device
        self.levels = levels  # bottom-up internal levels
        self.size = int(leaf_hashes.shape[-2])
        self.lanes = int(leaf_hashes.shape[0]) if leaf_hashes.dim() == 3 else None
        self._root_bytes = None  # bytes, or a list of them per lane

    @staticmethod
    def create(leaf_limbs, field: Field) -> "MerkleTree":
        """leaf_limbs: (N, n16) Montgomery limbs (N a power of two), or
        (B, N, n16) for a batch of B trees built together."""
        if leaf_limbs.dim() not in (2, 3):
            raise ValueError(f"expected (N, n16) or (B, N, n16) leaves, got "
                             f"{tuple(leaf_limbs.shape)}")
        n = leaf_limbs.shape[-2]
        if n & (n - 1) or n < 2:
            raise ValueError(f"a tree needs a power-of-two leaf count >= 2, got {n}")
        leaf_hashes, levels = build_levels(leaf_limbs)
        return MerkleTree(leaf_hashes, levels, field)

    def root_digest(self):
        """(8,) int32 root digest on the device; (B, 8) for a batch."""
        return self.levels[-1][..., 0, :]

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
        tree = MerkleTree(self.leaf_hashes[b], [level[b] for level in self.levels], self.field)
        if self._root_bytes is not None:
            tree._root_bytes = self._root_bytes[b]
        return tree

    def get_challenge_scalar_from_root(self) -> int:
        """Root -> field challenge (encode_root_into_challenge,
        src/iop/blake2s_trivial_iop.rs:226-234: BE read + shave)."""
        return self.field.from_be_with_shave(self.get_root())

    def path_digests(self, idx):
        """idx (Q,) int64 tensor on the device -> (depth, Q, 8) sibling
        digests bottom-up: the pair leaf hash, then internal siblings up
        to the root's children (src/iop/blake2s_trivial_iop.rs:281-311).
        A batch takes idx (B, Q), lane b's indices into lane b's tree, and
        gives (depth, B, Q, 8), one index op per level for all lanes."""
        if (idx.dim() == 2) != (self.lanes is not None):
            raise ValueError(f"indices {tuple(idx.shape)} do not fit a tree with lanes "
                             f"{self.lanes}")
        sibs = [take_rows(self.leaf_hashes, idx ^ 1)]
        cur = idx >> 1
        for level in self.levels[:-1]:
            sibs.append(take_rows(level, cur ^ 1))
            cur = cur >> 1
        return torch.stack(sibs, dim=0)

    def get_path(self, tree_index: int) -> List[bytes]:
        idx = torch.tensor([tree_index], dtype=torch.int64, device=self.leaf_hashes.device)
        sibs = self.path_digests(idx).cpu()
        return [digest_to_bytes(sibs[d, 0]) for d in range(sibs.shape[0])]

    def query(self, natural_index: int, leaf_values_canonical) -> IopQuery:
        """Produce an opening; leaf_values_canonical is a sequence of
        canonical ints (the committed vector)."""
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
