"""Plain keyed Blake2s-256 on PyTorch tensors, Merkle trees over it, and
the Fiat-Shamir transcript on hashlib: the reference's own.

The protocol hashes every leaf and node with Blake2s keyed with
b"Squeamish Ossifrage" and personalised with b"Shaftoe". A leaf is the
32-byte little-endian Montgomery form of an element, a node the 64 bytes
of its two children. The key block is the same for every hash, so each
hash is one compression from the state after it. Words are u32 values
held in int64 tensors with the words on the leading axis.
"""

from __future__ import annotations

import hashlib
import numpy as np
import torch

KEY = b"Squeamish Ossifrage"
PERSONAL = b"Shaftoe"
M32 = 0xFFFFFFFF
IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
HASH_CHUNK = 1 << 22  # messages a compression works on at once
KEEP_FROM = 5  # tree levels below this one are hashed again for an opening


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(h, m, t: int, final: bool):
    """One Blake2s compression: h (8, n) and m (16, n) u32 words in int64,
    t the byte counter, final the last-block flag -> (8, n)."""
    iv = torch.tensor(IV, dtype=torch.int64, device=h.device)[:, None]
    lo = (iv[4:] ^ torch.tensor([t & M32, (t >> 32) & M32, M32 if final else 0, 0],
                                dtype=torch.int64, device=h.device)[:, None])
    a, b, c, d = h[:4], h[4:], iv[:4].expand_as(h[:4]), lo.expand_as(h[:4])
    for s in SIGMA:
        a, b, c, d = _g(a, b, c, d, m[list(s[0:8:2])], m[list(s[1:8:2])])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, m[list(s[8:16:2])], m[list(s[9:16:2])])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def _midstate(device) -> torch.Tensor:
    param = bytearray(32)
    param[0], param[1], param[2], param[3] = 32, len(KEY), 1, 1
    param[24:32] = PERSONAL.ljust(8, b"\x00")
    h0 = np.array(IV, dtype=np.int64) ^ np.frombuffer(bytes(param), dtype="<u4").astype(np.int64)
    key_block = np.frombuffer(KEY.ljust(64, b"\x00"), dtype="<u4").astype(np.int64)
    return compress(torch.from_numpy(h0)[:, None].to(device),
                    torch.from_numpy(key_block)[:, None].to(device), 64, False)


def hash_messages(m, nbytes: int):
    """Keyed Blake2s of one block each: m (nbytes // 4, n) u32 words, in
    int64 or as int32 bits -> (8, n) int64 digests."""
    n = m.shape[1]
    mid = _midstate(m.device)
    out = torch.empty((8, n), dtype=torch.int64, device=m.device)
    for s in range(0, n, HASH_CHUNK):
        blk = m[:, s:s + HASH_CHUNK]
        full = torch.zeros((16, blk.shape[1]), dtype=torch.int64, device=m.device)
        full[:blk.shape[0]] = blk.to(torch.int64) & M32
        out[:, s:s + HASH_CHUNK] = compress(mid.expand(8, blk.shape[1]), full, 64 + nbytes, True)
    return out


def leaf_words(digits):
    """(16, n) Montgomery digits -> (8, n) int32 leaf words (u32 bits)."""
    n = digits.shape[1]
    out = torch.empty((8, n), dtype=torch.int32, device=digits.device)
    for s in range(0, n, HASH_CHUNK):
        d = digits[:, s:s + HASH_CHUNK]
        out[:, s:s + HASH_CHUNK] = (d[0::2] | (d[1::2] << 16)).to(torch.int32)
    return out


def words_to_digits(words):
    """(8, n) int32 leaf words -> (16, n) int64 digits."""
    w = words.to(torch.int64) & M32
    out = torch.empty((16,) + tuple(w.shape[1:]), dtype=torch.int64, device=w.device)
    out[0::2] = w & 0xFFFF
    out[1::2] = w >> 16
    return out


def _next_level(level):
    """(8, n) digests -> (8, n / 2) parents of the pairs (2i, 2i + 1)."""
    pairs = level.reshape(8, -1, 2)
    return hash_messages(torch.cat([pairs[:, :, 0], pairs[:, :, 1]]), 64)


def digest_bytes(words) -> bytes:
    return (np.asarray(words.cpu(), dtype=np.int64) & M32).astype("<u4").tobytes()


class Tree:
    """A Merkle tree over (8, n) int32 leaf words. It keeps the leaf words
    and the levels from KEEP_FROM up; an opening hashes the subtree under
    its kept ancestor again."""

    def __init__(self, words):
        if words.shape[1] < 2 or words.shape[1] & (words.shape[1] - 1):
            raise ValueError("a tree needs a power-of-two number of leaves, at least 2")
        self.words = words
        self.n = words.shape[1]
        self.depth = self.n.bit_length() - 1
        self.keep = min(KEEP_FROM, self.depth)
        level = hash_messages(words, 32)
        self.levels = {}
        for k in range(1, self.depth + 1):
            level = _next_level(level)
            if k >= self.keep:
                self.levels[k] = level.to(torch.int32)
        del level
        self.root = digest_bytes(self.levels[self.depth][:, 0])

    def opening(self, idx: int):
        """(leaf digits (16,), [sibling digest bytes, leaf level up])."""
        base = (idx >> self.keep) << self.keep
        level = hash_messages(self.words[:, base:base + (1 << self.keep)], 32)
        path = []
        for k in range(self.depth):
            sib = (idx >> k) ^ 1
            if k < self.keep:
                path.append(digest_bytes(level[:, sib - (base >> k)]))
                if k + 1 < self.keep:
                    level = _next_level(level)
            else:
                path.append(digest_bytes(self.levels[k][:, sib]))
        return words_to_digits(self.words[:, idx]), path


def blake2s_keyed(data: bytes) -> bytes:
    return hashlib.blake2s(data, key=KEY, person=PERSONAL).digest()


class Transcript:
    """The rolling keyed Blake2s transcript: commits absorb bytes; a
    challenge is the digest of the state so far, which is absorbed in
    turn."""

    def __init__(self, p: int):
        self.p = p
        self.state = hashlib.blake2s(key=KEY, person=PERSONAL)

    def commit(self, data: bytes) -> None:
        self.state.update(data)

    def commit_element(self, value: int) -> None:
        self.state.update(value.to_bytes(32, "big"))

    def challenge_bytes(self) -> bytes:
        d = self.state.copy().digest()
        self.state.update(d)
        return d

    def challenge(self) -> int:
        return element_from_bytes(self.challenge_bytes(), self.p)


def element_from_bytes(data: bytes, p: int) -> int:
    """32 bytes read big-endian, the top 64-bit word cut to the field's
    capacity (its bit length less one); a value at or above p is refused."""
    shave = 256 - (p.bit_length() - 1)
    value = int.from_bytes(data[:32], "big")
    top = (value >> 192) & (M32 << 32 | M32) >> (shave % 64)
    value = (value & ((1 << 192) - 1)) | (top << 192)
    if value >= p:
        raise ValueError("a challenge read from a digest is not below p")
    return value


def query_index(data: bytes, size: int, lde_factor: int) -> int:
    """The query index drawn from challenge bytes: the last 8 bytes
    big-endian mod the domain size, moved off multiples of the LDE factor
    and off even indices."""
    idx = int.from_bytes(data[-8:], "big") % size
    if idx % lde_factor == 0:
        idx = (idx + 1) % size
    if idx % 2 == 0:
        idx = (idx + 1) % size
    return idx
