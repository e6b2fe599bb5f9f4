"""Fq2 = F_p[u]/(u^2 + 1) extension field with square roots.

Port of the reference's square-root calculator
(src/experiments/square_root_calculator/fp2.rs: Field impl, norm,
mul_by_nonresidue, SqrtField::sqrt), used to generate VDF instances
backwards (square-root chains) over the 2^251+17*2^192+1 prime. Host
scalar arithmetic on Python ints; the non-residue is -1, matching the
VDF workloads (src/experiments/vdf.rs:35-37). A copy of
hodor_tpu/models/fp2.py for the port, which imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..field.field import Field


def tonelli_shanks(field: Field, a: int) -> Optional[int]:
    """Square root in F_p for p odd (None if a is a non-residue)."""
    p = field.p
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    s, q = field.S, field.t_odd
    z = field.generator  # a known non-residue (true multiplicative generator)
    m = s
    c = pow(z, q, p)
    t = pow(a, q, p)
    r = pow(a, (q + 1) // 2, p)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
            if i == m:
                return None
        b = pow(c, 1 << (m - i - 1), p)
        m = i
        c = b * b % p
        t = t * c % p
        r = r * b % p
    return r


@dataclasses.dataclass(frozen=True)
class Fq2:
    """c0 + c1*u with u^2 = -1."""

    field: Field
    c0: int
    c1: int

    def _n(self, v: int) -> int:
        return v % self.field.p

    @staticmethod
    def make(field: Field, c0: int, c1: int) -> "Fq2":
        return Fq2(field, c0 % field.p, c1 % field.p)

    @staticmethod
    def zero(field: Field) -> "Fq2":
        return Fq2(field, 0, 0)

    @staticmethod
    def one(field: Field) -> "Fq2":
        return Fq2(field, 1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def add(self, other: "Fq2") -> "Fq2":
        return Fq2.make(self.field, self.c0 + other.c0, self.c1 + other.c1)

    def sub(self, other: "Fq2") -> "Fq2":
        return Fq2.make(self.field, self.c0 - other.c0, self.c1 - other.c1)

    def neg(self) -> "Fq2":
        return Fq2.make(self.field, -self.c0, -self.c1)

    def mul(self, other: "Fq2") -> "Fq2":
        p = self.field.p
        ac = self.c0 * other.c0 % p
        bd = self.c1 * other.c1 % p
        c0 = (ac - bd) % p  # u^2 = -1
        c1 = (self.c0 * other.c1 + self.c1 * other.c0) % p
        return Fq2(self.field, c0, c1)

    def square(self) -> "Fq2":
        # (c0^2 - c1^2, 2*c0*c1), matching the VDF squaring with r = -1
        p = self.field.p
        return Fq2(
            self.field,
            (self.c0 * self.c0 - self.c1 * self.c1) % p,
            2 * self.c0 * self.c1 % p,
        )

    def norm(self) -> int:
        """c0^2 + c1^2 (norm map to F_p, fp2.rs norm)."""
        p = self.field.p
        return (self.c0 * self.c0 + self.c1 * self.c1) % p

    def conjugate(self) -> "Fq2":
        return Fq2.make(self.field, self.c0, -self.c1)

    def frobenius(self) -> "Fq2":
        """x -> x^p; for u^2 = -1 and p = 1 mod 4 this is conjugation
        composed with the action on u (here simply the conjugate)."""
        return self.conjugate()

    def inverse(self) -> "Fq2":
        from ..errors import DivisionByZeroError

        n = self.norm()
        if n == 0:
            raise DivisionByZeroError("inverse of zero in Fq2")
        ninv = self.field.inv(n)
        return Fq2.make(self.field, self.c0 * ninv, -self.c1 * ninv)

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one(self.field)
        base = self
        while e:
            if e & 1:
                result = result.mul(base)
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> Optional["Fq2"]:
        """Square root via the norm/complex method: with u^2 = -1,
        sqrt(a0 + a1 u) = x0 + x1 u where x0^2 = (a0 + alpha)/2,
        alpha = sqrt(a0^2 + a1^2), x1 = a1 / (2 x0)."""
        field = self.field
        p = field.p
        if self.is_zero():
            return Fq2.zero(field)
        if self.c1 == 0:
            r = tonelli_shanks(field, self.c0)
            if r is not None:
                return Fq2(field, r, 0)
            # sqrt of a non-residue lies on the u-axis: (x1 u)^2 = -x1^2
            r = tonelli_shanks(field, (-self.c0) % p)
            if r is None:
                return None
            return Fq2(field, 0, r)
        alpha = tonelli_shanks(field, self.norm())
        if alpha is None:
            return None
        two_inv = field.inv(2)
        x0sq = (self.c0 + alpha) * two_inv % p
        x0 = tonelli_shanks(field, x0sq)
        if x0 is None:
            x0sq = (self.c0 - alpha) * two_inv % p
            x0 = tonelli_shanks(field, x0sq)
            if x0 is None:
                return None
        x1 = self.c1 * field.inv(2 * x0 % p) % p
        return Fq2(field, x0, x1)


def sqrt_chain(field: Field, start: Tuple[int, int], length: int):
    """Generate a VDF witness backwards: repeated Fq2 square roots
    (the reference's intended use of the square-root calculator)."""
    cur = Fq2.make(field, *start)
    chain = [(cur.c0, cur.c1)]
    for _ in range(length):
        r = cur.sqrt()
        if r is None:
            raise ValueError("element has no square root; pick another start")
        cur = r
        chain.append((cur.c0, cur.c1))
    return chain
