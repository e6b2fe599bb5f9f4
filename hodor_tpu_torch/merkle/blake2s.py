"""Keyed Blake2s-256 for Merkle hashing on the device.

The reference hashes every leaf and node with keyed Blake2s
(key = b"Squeamish Ossifrage", personal = b"Shaftoe",
src/iop/blake2s_trivial_iop.rs:8-16). Leaves are 32-byte little-endian
raw (Montgomery) reprs (:36-42), nodes are 64-byte concatenations of two
child digests (:99-109). The key block is constant, so each hash is one
compression from the post-key midstate: the `blake2s` kernel of
field/kernels.py.

Words and digests are int32 tensors carrying u32 bit patterns.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np
import torch

from ..field import kernels
from ..profiling import form_counts

KEY = b"Squeamish Ossifrage"
PERSONAL = b"Shaftoe"

_IV = np.array(kernels.IV, dtype=np.uint32)


def compress(h, m, t: int, final: bool):
    """One Blake2s compression: h (..., 8) state words, m (..., 16) message
    words (little-endian), int32 tensors carrying u32 bit patterns, on
    their device; t the total byte counter, final whether m is the last
    block. -> (..., 8) int32 (hodor_tpu/merkle/blake2s.py compress)."""
    return kernels.blake2s_compress_plain(h, m, t, final)


def _param_words(digest_len: int, key_len: int, personal: bytes) -> np.ndarray:
    block = bytearray(32)
    block[0] = digest_len
    block[1] = key_len
    block[2] = 1  # fanout
    block[3] = 1  # depth
    block[24:32] = personal.ljust(8, b"\x00")
    return np.frombuffer(bytes(block), dtype="<u4").copy()


@lru_cache(maxsize=None)
def keyed_midstate(key: bytes = KEY, personal: bytes = PERSONAL) -> tuple:
    """State h after absorbing the (constant) padded key block, as 8 ints."""
    h0 = (_IV ^ _param_words(32, len(key), personal)).astype(np.int64)
    key_block = np.frombuffer(key.ljust(64, b"\x00"), dtype="<u4").astype(np.int64)
    h = compress(torch.from_numpy(h0), torch.from_numpy(key_block), t=64, final=False)
    return tuple(int(v) & 0xFFFFFFFF for v in h)


def hash_block(m_words, message_bytes: int):
    """Keyed Blake2s of one <=64-byte block per message:
    (..., message_bytes // 4) int32 words -> (..., 8) int32 digests."""
    return kernels.blake2s(m_words, message_bytes, keyed_midstate())


def hash_leaves(leaf_words):
    """(..., N, 8)-word 32-byte leaves -> (..., N, 8) digests (reference
    hash_encoded_leaf, src/iop/blake2s_trivial_iop.rs:92-99)."""
    return hash_block(leaf_words, 32)


def hash_nodes(left, right):
    """Pairs of 32-byte digests -> parent digests (reference hash_node,
    src/iop/blake2s_trivial_iop.rs:101-111)."""
    return hash_block(torch.cat([left, right], dim=-1), 64)


def limbs_to_leaf_words(limbs):
    """(..., N, n16) Montgomery limbs -> (..., N, 8) int32 LE leaf words: the raw
    repr bytes of the reference's leaf encoding
    (src/iop/blake2s_trivial_iop.rs:36-42), two 16-bit limbs per word,
    zero-padded to 32 bytes. The word is formed in int32: hi << 16 wraps
    into the sign bit, which gives the u32 word's bits (limbs are below
    2^16)."""
    n16 = limbs.shape[-1]
    if n16 % 2:
        raise ValueError("n16 must be even")
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    if n16 // 2 < 8:
        pad = torch.zeros(limbs.shape[:-1] + (8 - n16 // 2,), dtype=torch.int32,
                          device=limbs.device)
        words = torch.cat([words, pad], dim=-1)
    return words.contiguous()


# Leaves of more than this many rows a lane are hashed this many rows of
# each lane at a time into one preallocated digest tensor, so that the
# leaf words live a chunk at a time (1 GiB at 2^25 rows; hodor_tpu's
# _HASH_CHUNK, field/pallas_kernels.py:781-784). At every tree of a
# 2^20-row prove at lde 16 (2^25 leaves a lane), below the f, g and h2
# trees of a 2^22-row one (2^26, 2^27): set from the memory profile of
# those proves on an H100 80GB HBM3 (tools/memory_profile.py, PERF.md §6).
HASH_CHUNK = 1 << 25


def hash_leaf_limbs(leaf_limbs):
    """(..., N, n16) Montgomery limbs -> (..., N, 8) leaf digests: the leaf
    words and their hashes, over chunks of HASH_CHUNK rows of the N axis
    where N is larger."""
    n = leaf_limbs.shape[-2]
    if n <= HASH_CHUNK:
        return hash_leaves(limbs_to_leaf_words(leaf_limbs))
    form_counts["leaves_chunked"] += 1
    out = torch.empty(leaf_limbs.shape[:-1] + (8,), dtype=torch.int32, device=leaf_limbs.device)
    for r0 in range(0, n, HASH_CHUNK):
        out[..., r0:r0 + HASH_CHUNK, :] = hash_leaves(
            limbs_to_leaf_words(leaf_limbs[..., r0:r0 + HASH_CHUNK, :]))
    return out


def digest_to_challenge_mont(ops, digest):
    """Device analog of encode_root_into_challenge
    (src/iop/blake2s_trivial_iop.rs:226-234 -> from_be_with_shave): map a
    (..., 8) int32 LE-word digest to the Montgomery-form field element the
    host derives from its bytes (read repr_size bytes big-endian, mask
    the top u64 limb). Bit-exact with Field.from_be_with_shave for the
    reference fields, whose shave mask keeps the value below p."""
    field = ops.field
    n16 = ops.n16
    rs = field.repr_size  # == 2 * n16 bytes read big-endian
    d = digest.to(torch.int64) & 0xFFFFFFFF
    limbs = []
    for i in range(n16):
        b0 = rs - 1 - 2 * i  # raw digest index of canonical LE byte 2i
        b1 = rs - 2 - 2 * i
        lo = (d[..., b0 // 4] >> (8 * (b0 % 4))) & 0xFF
        hi = (d[..., b1 // 4] >> (8 * (b1 % 4))) & 0xFF
        limbs.append(lo | (hi << 8))
    x = torch.stack(limbs, dim=-1)  # canonical, unmasked
    shave = 256 - field.capacity
    mask64 = 0xFFFFFFFFFFFFFFFF >> (shave % 64)
    masks = [0xFFFF] * n16
    for k in range(4):
        masks[4 * (field.n64 - 1) + k] = (mask64 >> (16 * k)) & 0xFFFF
    x = x & torch.tensor(masks, dtype=torch.int64, device=digest.device)
    return ops.to_mont_arr(x.to(torch.int32))


def blake2s_keyed(data: bytes) -> bytes:
    """Host keyed hash (transcript and path verification)."""
    return hashlib.blake2s(data, key=KEY, person=PERSONAL).digest()


def digest_to_bytes(words) -> bytes:
    """(8,) digest words (int32 or uint32 bit patterns) -> 32 bytes."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(words).astype(np.int64) & 0xFFFFFFFF).astype("<u4").tobytes()
