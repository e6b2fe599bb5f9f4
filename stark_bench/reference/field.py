"""Plain prime-field arithmetic on PyTorch tensors: the reference's own.

An element is 16 digits of 16 bits, least significant first, on the
leading axis of an int64 tensor: shape (16, ...). Every value is
canonical (each digit below 2^16, the value below p) and in Montgomery
form x * 2^256 mod p, which is the form the protocol hashes. A product
is a schoolbook digit product, one Montgomery reduction by R = 2^256
and one conditional subtraction; the reduction's two products by
constants are float64 matrix products, exact since every column sum
stays below 2^53. Carries run digit by digit. Large operands are taken
in chunks of CHUNK elements, so the temporaries stay bounded.

Nothing here is fast; all of it is exact, and it shares no code with
the program under test.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

D = 16  # digits an element
MASK = 0xFFFF
CHUNK = 1 << 21  # elements a product works on at once


def _digits(x: int, n: int = D) -> List[int]:
    return [(x >> (16 * k)) & MASK for k in range(n)]


def _align(a: torch.Tensor, b: torch.Tensor):
    """Broadcast two digit tensors over their element axes, right-aligned
    after the digit axis: (16, n) against (16, 1) or (16, m, n)."""
    while a.dim() < b.dim():
        a = a.unsqueeze(1)
    while b.dim() < a.dim():
        b = b.unsqueeze(1)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return a, b, shape


def _chunked(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fn over (16, k) pieces of the broadcast operands, CHUNK elements at
    a time, into one (16, ...) result."""
    a, b, shape = _align(a, b)
    a2 = a.expand(shape).reshape(D, -1)
    b2 = b.expand(shape).reshape(D, -1)
    n = a2.shape[1]
    if n <= CHUNK:
        return fn(a2, b2).reshape(shape)
    out = torch.empty((D, n), dtype=torch.int64, device=a.device)
    for s in range(0, n, CHUNK):
        out[:, s:s + CHUNK] = fn(a2[:, s:s + CHUNK], b2[:, s:s + CHUNK])
    return out.reshape(shape)


def _carry(t: torch.Tensor, n: int) -> None:
    """Propagate the carries of rows 0..n-1 of t into the row above,
    in place: rows 0..n-1 end in [0, 2^16), floor carries for negatives."""
    for k in range(n):
        c = t[k] >> 16
        t[k] &= MASK
        t[k + 1] += c


class PlainField:
    """F_p for an odd prime p below 2^255 on `device`."""

    def __init__(self, p: int, generator: int, device="cpu"):
        if not (2 < p < 1 << 255):
            raise ValueError("the field must be of an odd prime below 2^255")
        self.p = p
        self.generator = generator
        self.device = torch.device(device)
        self.R = 1 << 256
        self.s = ((p - 1) & -(p - 1)).bit_length() - 1  # 2-adicity
        self.root_of_unity = pow(generator, (p - 1) >> self.s, p)
        pinv = (-pow(p, -1, self.R)) % self.R
        dev = self.device
        self._p = torch.tensor(_digits(p), dtype=torch.int64, device=dev)[:, None]
        # column k of m * P is sum_j m_j P_{k-j}: a (32, 16) Toeplitz matrix
        tp = np.zeros((2 * D, D))
        tl = np.zeros((D, D))
        pd, qd = _digits(p), _digits(pinv)
        for k in range(2 * D):
            for j in range(D):
                if 0 <= k - j < D:
                    tp[k, j] = pd[k - j]
                    if k < D:
                        tl[k, j] = qd[k - j]
        self._tp = torch.tensor(tp, dtype=torch.float64, device=dev)
        self._tl = torch.tensor(tl, dtype=torch.float64, device=dev)
        self.zero = self.const(0)

    # ---------------------------------------------------------- host side

    def digits_of(self, values: Iterable[int]) -> torch.Tensor:
        """Canonical ints -> (16, n) digits of the same ints (no Montgomery)."""
        raw = b"".join(int(v).to_bytes(32, "little") for v in values)
        arr = np.frombuffer(raw, dtype="<u2").reshape(-1, D).astype(np.int64)
        return torch.from_numpy(arr.T.copy()).to(self.device)

    def ints_of(self, t: torch.Tensor) -> List[int]:
        """(16, ...) digits -> the ints they hold, flattened, no Montgomery."""
        arr = t.reshape(D, -1).T.cpu().numpy().astype("<u2")
        raw = arr.tobytes()
        return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(arr.shape[0])]

    def encode(self, values: Iterable[int]) -> torch.Tensor:
        """Canonical ints -> (16, n) Montgomery digits."""
        return self.mul(self.digits_of([v % self.p for v in values]), self.const_raw(self.R * self.R % self.p))

    def decode(self, t: torch.Tensor) -> List[int]:
        """(16, ...) Montgomery digits -> canonical ints, flattened."""
        rinv = pow(self.R, -1, self.p)
        return [v * rinv % self.p for v in self.ints_of(t)]

    def const_raw(self, x: int) -> torch.Tensor:
        return torch.tensor(_digits(x), dtype=torch.int64, device=self.device)[:, None]

    def const(self, x: int) -> torch.Tensor:
        """A scalar as (16, 1) Montgomery digits."""
        return self.const_raw(x % self.p * self.R % self.p)

    # -------------------------------------------------------- arithmetic

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _chunked(self._mul, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _chunked(self._add, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _chunked(self._sub, a, b)

    def _mul(self, a, b):
        n = a.shape[1]
        t = torch.zeros((2 * D + 1, n), dtype=torch.int64, device=a.device)
        for i in range(D):
            t[i:i + D].addcmul_(b, a[i])
        _carry(t, 2 * D)
        m = torch.matmul(self._tl, t[:D].to(torch.float64)).to(torch.int64)
        _carry(m, D - 1)
        m[D - 1] &= MASK
        t[:2 * D] += torch.matmul(self._tp, m.to(torch.float64)).to(torch.int64)
        _carry(t, 2 * D)
        return self._reduce_once(t[D:2 * D + 1].clone())

    def _reduce_once(self, r):
        """r (17, n): canonical digits of a value below 2p (row 16 zero)
        -> (16, n) digits of the value mod p."""
        d = r.clone()
        d[:D] -= self._p
        _carry(d, D)
        return torch.where(d[D] < 0, r[:D], d[:D])

    def _add(self, a, b):
        s = torch.zeros((D + 1, a.shape[1]), dtype=torch.int64, device=a.device)
        s[:D] = a + b
        _carry(s, D)
        return self._reduce_once(s)

    def _sub(self, a, b):
        d = torch.zeros((D + 1, a.shape[1]), dtype=torch.int64, device=a.device)
        d[:D] = a - b
        _carry(d, D)
        neg = d[D] < 0
        d[D] = 0
        e = d + torch.cat([self._p, self._p[:1] * 0])
        _carry(e, D)
        return torch.where(neg, e[:D], d[:D])

    def powers(self, x: int, n: int, start: int = 1) -> torch.Tensor:
        """(16, n): start * x^i for i < n, by doubling."""
        out = self.const(start)
        while out.shape[1] < n:
            k = out.shape[1]
            out = torch.cat([out, self.mul(out, self.const(pow(x, k, self.p)))], dim=1)
        return out[:, :n].contiguous()

    def suffix_sums(self, a):
        """(16, n) -> (16, n): out[i] = sum of a[j] for j > i (Hillis-Steele)."""
        n = a.shape[1]
        s = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        k = 1
        while k < n:
            shifted = torch.cat([s[:, k:], torch.zeros_like(s[:, :k])], dim=1)
            s = self.add(s, shifted)
            k *= 2
        return s
