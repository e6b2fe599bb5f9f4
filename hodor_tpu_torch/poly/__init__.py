"""Polynomial abstraction (reference: src/polynomials/mod.rs), a port of
hodor_tpu/poly/__init__.py.

The reference encodes the coefficient/value duality at the type level
(`Polynomial<F, Coefficients|Values>`, src/polynomials/mod.rs:14-34).
Here `Polynomial` is a thin host wrapper over a (N, n16) int32 tensor of
Montgomery limbs plus its form tag; every method delegates to the port's
NTTs and LimbOps on the tensor's device. The protocol layers (arp, ali,
fri) work on raw tensors; this class is the user-facing algebra API with
the reference's method surface. Constructors place the data on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Iterable, List, Union

import torch

from ..domain import Domain, next_power_of_two
from ..errors import DivisionByZeroError
from ..field.field import Field
from ..field.limbs import LimbOps
from ..ntt import coset_ntt, distribute_powers, evaluate_at, icoset_ntt, intt, lde as lde_fn, ntt

COEFFICIENTS = "coefficients"
VALUES = "values"


@lru_cache(maxsize=None)
def _ops(field: Field, device: torch.device) -> LimbOps:
    """One LimbOps (and its cached tables) per field and device."""
    return LimbOps(field, device)


@dataclasses.dataclass
class Polynomial:
    """A polynomial in coefficient or value form over a 2^k domain."""

    data: torch.Tensor  # (N, n16) Montgomery limbs
    form: str
    field: Field

    # ---- constructors (from_coeffs/from_values pad to a power of two,
    #      src/polynomials/mod.rs:146-166, 722-742) ----

    @staticmethod
    def from_coeffs(field: Field, coeffs: Union[Iterable[int], torch.Tensor],
                    device="cuda") -> "Polynomial":
        return Polynomial(_encode_padded(field, coeffs, device), COEFFICIENTS, field)

    @staticmethod
    def from_values(field: Field, values: Union[Iterable[int], torch.Tensor],
                    device="cuda") -> "Polynomial":
        return Polynomial(_encode_padded(field, values, device), VALUES, field)

    @staticmethod
    def from_roots(field: Field, roots: List[int], device="cuda") -> "Polynomial":
        """Product tree prod(X - r_i) (src/polynomials/mod.rs:168-227).

        The reference builds the tree with one task per subtree; here each
        tree level is one batch: the K degree-M factor polynomials multiply
        pairwise through one batched (NTT -> pointwise mul -> iNTT) over a
        (K, 2M, n16) tensor. O(n log^2 n) in all."""
        if not roots:
            return Polynomial.from_coeffs(field, [1], device)
        ops = _ops(field, torch.device(device))
        k = next_power_of_two(len(roots))
        # leaves (k, 2, n16): (X - r) for the roots, the constant 1 as filler
        leaf_ints = [[(-r) % field.p, 1] for r in roots] + [[1, 0]] * (k - len(roots))
        cur = ops.encode(leaf_ints)
        while cur.shape[0] > 1:
            cur = _product_tree_level(ops, cur)
        out_len = next_power_of_two(len(roots) + 1)
        return Polynomial(cur[0, :out_len], COEFFICIENTS, field)

    # ---- basic properties ----

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    @property
    def domain(self) -> Domain:
        return Domain.new_for_size(self.field, self.size)

    @property
    def ops(self) -> LimbOps:
        return _ops(self.field, self.data.device)

    def as_ints(self):
        """Decode to canonical Python ints (host)."""
        return [int(v) for v in self.ops.decode(self.data)]

    def _require(self, form: str) -> None:
        if self.form != form:
            raise ValueError(f"this operation takes a polynomial in {form} form, not {self.form}")

    def _new(self, data, form=None) -> "Polynomial":
        return Polynomial(data, self.form if form is None else form, self.field)

    # ---- transforms (src/polynomials/mod.rs:611-638, 773-815) ----

    def fft(self) -> "Polynomial":
        self._require(COEFFICIENTS)
        return self._new(ntt(self.ops, self.data), VALUES)

    def ifft(self) -> "Polynomial":
        self._require(VALUES)
        return self._new(intt(self.ops, self.data), COEFFICIENTS)

    def coset_fft(self) -> "Polynomial":
        self._require(COEFFICIENTS)
        return self._new(coset_ntt(self.ops, self.data), VALUES)

    def icoset_fft(self) -> "Polynomial":
        self._require(VALUES)
        return self._new(icoset_ntt(self.ops, self.data), COEFFICIENTS)

    def lde(self, factor: int) -> "Polynomial":
        """LDE via factor-many coset NTTs (src/polynomials/mod.rs:418-482)."""
        self._require(COEFFICIENTS)
        return self._new(lde_fn(self.ops, self.data, factor), VALUES)

    def coset_lde(self, factor: int) -> "Polynomial":
        self._require(COEFFICIENTS)
        return self._new(lde_fn(self.ops, self.data, factor, coset=True), VALUES)

    # ---- elementwise algebra (src/polynomials/mod.rs:54-135, 744-887) ----

    def _check(self, other: "Polynomial"):
        if self.form != other.form or self.size != other.size:
            raise ValueError(f"operands differ: {self.form} of {self.size} and {other.form} "
                             f"of {other.size}")

    def add(self, other: "Polynomial") -> "Polynomial":
        self._check(other)
        return self._new(self.ops.add(self.data, other.data))

    def sub(self, other: "Polynomial") -> "Polynomial":
        self._check(other)
        return self._new(self.ops.sub(self.data, other.data))

    def mul(self, other: "Polynomial") -> "Polynomial":
        """Pointwise product (value form only, like the reference)."""
        self._require(VALUES)
        self._check(other)
        return self._new(self.ops.mul(self.data, other.data))

    def add_assign_scaled(self, other: "Polynomial", scale: int) -> "Polynomial":
        self._check(other)
        ops = self.ops
        return self._new(ops.add(self.data, ops.mul(other.data, ops.const(scale))))

    def scale(self, c: int) -> "Polynomial":
        return self._new(self.ops.mul(self.data, self.ops.const(c)))

    def negate(self) -> "Polynomial":
        return self._new(self.ops.neg(self.data))

    def add_constant(self, c: int) -> "Polynomial":
        return self._new(self.ops.add(self.data, self.ops.const(c)))

    def pow(self, e: int) -> "Polynomial":
        self._require(VALUES)
        return self._new(self.ops.pow_static(self.data, e))

    def square(self) -> "Polynomial":
        return self._new(self.ops.square(self.data))

    def distribute_powers(self, g: int) -> "Polynomial":
        return self._new(distribute_powers(self.ops, self.data, self.ops.const(g)))

    def batch_inversion(self) -> "Polynomial":
        """src/polynomials/mod.rs:889-954; raises on zero elements, as the
        reference's batch_inversion returns Err."""
        if bool(self.ops.is_zero(self.data).any()):
            raise DivisionByZeroError("batch inversion of a zero element")
        return self._new(self.ops.batch_inverse(self.data))

    def evaluate_at(self, x: int) -> int:
        self._require(COEFFICIENTS)
        return int(self.ops.decode(evaluate_at(self.ops, self.data, self.ops.const(x))))


def _product_tree_level(ops: LimbOps, polys):
    """One product-tree level: (K, M, n16) coefficient polys (degree < M)
    -> (K/2, 2M, n16) pairwise products, all batched through the NTT."""
    padded = torch.cat([polys, torch.zeros_like(polys)], dim=1)  # 2M points hold degree < 2M-1
    vals = ntt(ops, padded)
    return intt(ops, ops.mul(vals[0::2], vals[1::2]))


def _encode_padded(field: Field, data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    data = list(data)
    n = next_power_of_two(len(data))
    data = [int(v) % field.p for v in data] + [0] * (n - len(data))
    return _ops(field, torch.device(device)).encode(data)
