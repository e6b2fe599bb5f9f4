"""Generic hasher interface (reference: src/utils/mod.rs:14-106).

The reference defines a `Hasher` trait with Keccak256 and Sha256
implementations; they are not used by the proving path (Blake2s is) but
are part of the utility surface. A copy of hodor_tpu/utils/hashers.py for
the port, which imports nothing of that package.
"""

from __future__ import annotations

import hashlib


class Hasher:
    digest_size: int = 32

    def __init__(self):
        self._parts = []

    def update(self, data: bytes) -> None:
        self._parts.append(bytes(data))

    def finalize(self) -> bytes:
        raise NotImplementedError


class Sha256Hasher(Hasher):
    def finalize(self) -> bytes:
        h = hashlib.sha256()
        for p in self._parts:
            h.update(p)
        self._parts = []
        return h.digest()


class Keccak256Hasher(Hasher):
    """Keccak-256 (the pre-NIST padding variant Ethereum uses, matching
    the reference's tiny_keccak)."""

    def finalize(self) -> bytes:
        # hashlib's sha3_256 is NIST SHA-3, whose padding differs
        return _keccak256(b"".join(self._parts))


def _keccak256(data: bytes) -> bytes:
    """Minimal Keccak-f[1600] sponge with rate 1088, pad 0x01 (legacy
    Keccak-256, as in tiny_keccak used by the reference)."""
    RC = [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
        0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
        0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
        0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
        0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ]
    ROT = [
        [0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14],
    ]
    M = (1 << 64) - 1

    def rol(x, n):
        return ((x << n) | (x >> (64 - n))) & M

    def keccak_f(st):
        for rnd in range(24):
            # theta
            c = [st[x][0] ^ st[x][1] ^ st[x][2] ^ st[x][3] ^ st[x][4] for x in range(5)]
            d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
            for x in range(5):
                for y in range(5):
                    st[x][y] ^= d[x]
            # rho + pi
            b = [[0] * 5 for _ in range(5)]
            for x in range(5):
                for y in range(5):
                    b[y][(2 * x + 3 * y) % 5] = rol(st[x][y], ROT[x][y])
            # chi
            for x in range(5):
                for y in range(5):
                    st[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & M)
            # iota
            st[0][0] ^= RC[rnd]
        return st

    rate = 136
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    st = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            st[i % 5][i // 5] ^= lane
        st = keccak_f(st)
    out = b""
    for i in range(4):
        out += st[i % 5][i // 5].to_bytes(8, "little")
    return out
