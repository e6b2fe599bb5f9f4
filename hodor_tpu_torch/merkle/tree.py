"""Merkle tree build / query / verify over Blake2s digests.

Reference: Blake2sIopTree (src/iop/blake2s_trivial_iop.rs:113-290) with
the TrivialCombiner (natural index == tree index, leaf pairs (2i, 2i+1),
src/iop/trivial_coset_combiner.rs). Levels are built bottom-up with one
hashing launch each; a level's (N/2, 16) node messages are the level
below read as pairs, so no copy is made between levels.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..field.field import Field
from .blake2s import (
    blake2s_keyed,
    digest_to_bytes,
    hash_block,
    hash_leaves,
    limbs_to_leaf_words,
)


def build_levels(leaf_limbs):
    """leaf_limbs (N, n16) -> (leaf_hashes (N, 8), levels): levels[0] is
    the first internal level (N/2 digests), levels[-1] the root (1)."""
    leaf_hashes = hash_leaves(limbs_to_leaf_words(leaf_limbs))
    levels = []
    cur = leaf_hashes
    while cur.shape[0] > 1:
        cur = hash_block(cur.reshape(cur.shape[0] // 2, 16), 64)
        levels.append(cur)
    return leaf_hashes, levels


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
    """Device-built Blake2s commitment tree over field-element leaves."""

    def __init__(self, leaf_hashes, levels, field: Field):
        self.field = field
        self.leaf_hashes = leaf_hashes  # (N, 8) int32 on the device
        self.levels = levels  # bottom-up internal levels
        self.size = int(leaf_hashes.shape[0])
        self._root_bytes = None

    @staticmethod
    def create(leaf_limbs, field: Field) -> "MerkleTree":
        """leaf_limbs: (N, n16) Montgomery limbs (N a power of two)."""
        n = leaf_limbs.shape[0]
        if n & (n - 1) or n < 2:
            raise ValueError(f"a tree needs a power-of-two leaf count >= 2, got {n}")
        leaf_hashes, levels = build_levels(leaf_limbs)
        return MerkleTree(leaf_hashes, levels, field)

    def root_digest(self):
        """(8,) int32 root digest on the device."""
        return self.levels[-1][0]

    def get_root(self) -> bytes:
        if self._root_bytes is None:
            self._root_bytes = digest_to_bytes(self.root_digest())
        return self._root_bytes

    def get_challenge_scalar_from_root(self) -> int:
        """Root -> field challenge (encode_root_into_challenge,
        src/iop/blake2s_trivial_iop.rs:226-234: BE read + shave)."""
        return self.field.from_be_with_shave(self.get_root())

    def path_digests(self, idx):
        """idx (Q,) int64 tensor on the device -> (depth, Q, 8) sibling
        digests bottom-up: the pair leaf hash, then internal siblings up
        to the root's children (src/iop/blake2s_trivial_iop.rs:281-311)."""
        sibs = [self.leaf_hashes[idx ^ 1]]
        cur = idx >> 1
        for level in self.levels[:-1]:
            sibs.append(level[cur ^ 1])
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


def fetch_roots(trees: List[MerkleTree]) -> List[bytes]:
    """Root bytes of several trees, fetched in one device-to-host copy;
    each tree keeps its root."""
    digests = torch.stack([t.root_digest() for t in trees]).cpu()
    for tree, digest in zip(trees, digests):
        tree._root_bytes = digest_to_bytes(digest)
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
