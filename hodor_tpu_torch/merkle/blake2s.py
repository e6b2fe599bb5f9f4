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

KEY = b"Squeamish Ossifrage"
PERSONAL = b"Shaftoe"

_IV = np.array(kernels.IV, dtype=np.uint32)


def _rotr(x, r):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _compress_host(h, m, t: int, final: bool) -> np.ndarray:
    """One Blake2s compression on the host (numpy uint32)."""
    with np.errstate(over="ignore"):
        v = [np.uint32(h[i]) for i in range(8)] + [np.uint32(c) for c in _IV]
        v[12] = v[12] ^ np.uint32(t & 0xFFFFFFFF)
        v[13] = v[13] ^ np.uint32((t >> 32) & 0xFFFFFFFF)
        if final:
            v[14] = v[14] ^ np.uint32(0xFFFFFFFF)

        def g(a, b, c, d, x, y):
            v[a] = v[a] + v[b] + x
            v[d] = _rotr(v[d] ^ v[a], 16)
            v[c] = v[c] + v[d]
            v[b] = _rotr(v[b] ^ v[c], 12)
            v[a] = v[a] + v[b] + y
            v[d] = _rotr(v[d] ^ v[a], 8)
            v[c] = v[c] + v[d]
            v[b] = _rotr(v[b] ^ v[c], 7)

        for r in range(10):
            s = kernels.SIGMA[r]
            mm = [np.uint32(m[s[i]]) for i in range(16)]
            g(0, 4, 8, 12, mm[0], mm[1])
            g(1, 5, 9, 13, mm[2], mm[3])
            g(2, 6, 10, 14, mm[4], mm[5])
            g(3, 7, 11, 15, mm[6], mm[7])
            g(0, 5, 10, 15, mm[8], mm[9])
            g(1, 6, 11, 12, mm[10], mm[11])
            g(2, 7, 8, 13, mm[12], mm[13])
            g(3, 4, 9, 14, mm[14], mm[15])
        return np.array([h[i] ^ v[i] ^ v[i + 8] for i in range(8)], dtype=np.uint32)


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
    h0 = _IV ^ _param_words(32, len(key), personal)
    key_block = np.frombuffer(key.ljust(64, b"\x00"), dtype="<u4")
    return tuple(int(v) for v in _compress_host(h0, key_block, t=64, final=False))


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
    zero-padded to 32 bytes. The word is formed in int64 and narrowed,
    since hi << 16 overflows int32."""
    n16 = limbs.shape[-1]
    if n16 % 2:
        raise ValueError("n16 must be even")
    lo = limbs[..., 0::2].to(torch.int64)
    hi = limbs[..., 1::2].to(torch.int64)
    words = kernels.u32_to_i32(lo | (hi << 16))
    if n16 // 2 < 8:
        pad = torch.zeros(limbs.shape[:-1] + (8 - n16 // 2,), dtype=torch.int32,
                          device=limbs.device)
        words = torch.cat([words, pad], dim=-1)
    return words.contiguous()


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
