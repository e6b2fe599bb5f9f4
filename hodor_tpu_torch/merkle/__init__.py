"""Blake2s Merkle-tree IOP commitments (reference: src/iop/*)."""

from .blake2s import (
    KEY,
    PERSONAL,
    blake2s_keyed,
    hash_leaves,
    hash_nodes,
    limbs_to_leaf_words,
)
from .tree import IopQuery, MerkleTree, verify_path

__all__ = [
    "KEY",
    "PERSONAL",
    "blake2s_keyed",
    "hash_leaves",
    "hash_nodes",
    "limbs_to_leaf_words",
    "MerkleTree",
    "verify_path",
    "IopQuery",
]
