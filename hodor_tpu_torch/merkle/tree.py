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
lets each level go once the next is built, and it keeps only its top
levels, from the one of N / 2^k digests up to the root, k = ⌊log2 N / 2⌋
(hodor_tpu's tree_drop_min keeps the root alone): fewer than
2^(⌈log2 N / 2⌉ + 1) digests a lane, 1 MiB at 2^27 leaves. An opening
gathers the 2^k committed rows under each queried index, hashes those
subtrees (one launch a level for every index and lane) and takes the
lower siblings from them and the upper ones from the kept levels, so it
hashes Q 2^k leaves again, not N.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..field.field import Field
from ..field.limbs import fetch_together
from ..profiling import form_counts, reopen_counts, span
from .blake2s import blake2s_keyed, digest_to_bytes, hash_block, hash_leaf_limbs

# Trees over at least this many leaves (a lane's) are dropped, keeping
# their top levels only (about 512 KiB at 2^26 leaves). Above every tree
# of a 2^20-row prove at lde 16 (2^25 leaves), at the f, g, h1 and h2
# trees of a 2^22-row one (2^26 and 2^27 leaves): set from the memory
# profile of those proves on an H100 80GB HBM3 (tools/memory_profile.py,
# PERF.md §6).
TREE_DROP_MIN = 1 << 26


def next_level(cur):
    """(..., M, 8) digests -> (..., M/2, 8) parents: the pairs read in
    place as (..., M/2, 16) words, one launch for all leading dims."""
    return hash_block(cur.reshape(cur.shape[:-2] + (cur.shape[-2] // 2, 16)), 64)


def build_levels(leaf_limbs, lost: int = 0):
    """leaf_limbs (..., N, n16) -> the levels bottom-up: levels[0] the leaf
    hashes (..., N, 8), levels[-1] the roots (..., 1, 8). One launch per
    level for all leading dims. The lowest `lost` levels are each let go
    once the next is built, and left out."""
    levels = []
    cur = hash_leaf_limbs(leaf_limbs)
    for j in range(leaf_limbs.shape[-2].bit_length()):
        if j:
            cur = next_level(cur)
        if j >= lost:
            levels.append(cur)
    return levels


def subtree_depth(n: int) -> int:
    """k = ⌊log2 n / 2⌋: a dropped tree of n leaves lets go of its leaf
    hashes and the k − 1 internal levels above them, and an opening hashes
    the 2^k leaves under each queried index."""
    return (n.bit_length() - 1) // 2


def subtree_path_digests(leaf_limbs, idx, k: int):
    """The k lowest siblings of each path, from the committed leaves:
    gather the 2^k rows under each index's ancestor at level k, hash those
    subtrees together and take the siblings from them. leaf_limbs
    (N, n16) with idx (Q,), or (B, N, n16) with idx (B, Q) -> k tensors
    of (Q, 8), or (B, Q, 8)."""
    base = (idx >> k) << k
    rows = base[..., None] + torch.arange(1 << k, dtype=idx.dtype, device=idx.device)
    sub = take_rows(leaf_limbs, rows)  # (..., Q, 2^k, n16)
    reopen_counts["openings"] += 1
    reopen_counts["leaves_hashed"] += rows.numel()
    local = idx - base
    return [torch.take_along_dim(level, ((local >> j) ^ 1)[..., None, None], dim=-2)[..., 0, :]
            for j, level in enumerate(build_levels(sub)[:-1])]


def take_rows(t, idx):
    """Rows idx of t: t (N, C) with idx (Q, ...) -> (Q, ..., C), or t
    (B, N, C) with idx (B, Q, ...) -> (B, Q, ..., C), lane b's rows from
    lane b (one index op over all lanes; t may be a strided view, nothing
    is copied but the rows taken)."""
    if t.dim() == 2:
        return t[idx]
    lanes = torch.arange(t.shape[0], dtype=idx.dtype, device=idx.device)
    return t[lanes.view((-1,) + (1,) * (idx.dim() - 1)), idx]


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
    tree or a batch of B trees of equal size (a leading lane axis). It
    holds its levels bottom-up, levels[-1] the roots; a dropped tree holds
    only the top ones (`lost` levels let go below them)."""

    def __init__(self, levels, field: Field, size: int):
        self.field = field
        self.size = size
        self.levels = levels  # (..., size >> (lost + j), 8) for j = 0, 1, ...
        self.root = levels[-1][..., 0, :]  # (8,) or (B, 8) int32 digest on the device
        self.lanes = int(self.root.shape[0]) if self.root.dim() == 2 else None
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
        lost = 0
        if n >= TREE_DROP_MIN:
            form_counts["trees_dropped"] += 1
            lost = subtree_depth(n)
        return MerkleTree(build_levels(leaf_limbs, lost), field, n)

    @property
    def lost(self) -> int:
        """How many levels, the leaf hashes first, the tree let go."""
        return self.size.bit_length() - len(self.levels)

    @property
    def dropped(self) -> bool:
        return self.lost > 0

    @property
    def leaf_hashes(self):
        """(N, 8) or (B, N, 8) leaf digests; None once dropped."""
        return None if self.dropped else self.levels[0]

    def drop(self) -> None:
        """Let the levels below the top ones go, as a tree dropped at its
        build keeps them; openings hash the subtrees under their indices
        again."""
        self.levels = self.levels[subtree_depth(self.size) - self.lost:]

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
        tree = MerkleTree([level[b] for level in self.levels], self.field, self.size)
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
        values: the committed (..., N, n16) leaves, from which a dropped
        tree hashes the subtrees under idx again (`subtree_path_digests`);
        the siblings above them come from the kept levels."""
        if (idx.dim() == 2) != (self.lanes is not None):
            raise ValueError(f"indices {tuple(idx.shape)} do not fit a tree with lanes "
                             f"{self.lanes}")
        k = self.lost
        sibs, cur = [], idx
        if k:
            if values is None:
                raise ValueError("a dropped tree opens from its committed values: "
                                 "path_digests(idx, values)")
            with span("merkle.reopen"):
                sibs = subtree_path_digests(values, idx, k)
            cur = idx >> k
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
