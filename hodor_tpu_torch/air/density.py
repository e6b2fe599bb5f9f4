"""Shared semantics for the three constraint densities.

The reference declares Dense / Repeated / Sparse (src/air/mod.rs:29-57)
but only Dense is implemented downstream — ARP's DensityQuery
(src/arp/density_query.rs:20-44), ALI's divisor builder
(src/ali/per_register/mod.rs:60-192) and the verifier's scalar divisor
(src/verifier/mod.rs:635-677) all `unimplemented!()` on the other two.
This module implements all three, with one definition shared by the
prover's ALI precompute, the ARP satisfiability checker and the
verifier's scalar divisor so the three cannot drift:

  Dense(start_at, span)        active rows [start_at, num_rows - span)
  Repeated(start_at, span, k)  active rows {start_at + m*k} below
                               num_rows - span (reference comment
                               src/air/mod.rs:35-36: "happens start_at,
                               start_at + interval, ...; Span ... will
                               not allow to wrap around the trace")
  Sparse(rows)                 active exactly at `rows`
                               (src/air/mod.rs:46-50)

Divisor form (what ALI divides the composed constraint values by): the
vanishing polynomial Z_D of the active row set, expressed so it is
cheap on device:

  dense:    Z = (X^T - 1) / prod_{excluded r}(X - g^r)
  repeated: Z = (X^(T/k) - g^(start_at * T/k)) / prod_{excluded}(X - g^r)
            [the roots of X^(T/k) = g^(s*T/k) are exactly g^(s + m*k)]
  sparse:   Z = prod_{r in rows}(X - g^r)

where T = column_domain.size, g = column_domain.generator, and
"excluded" are the rows of the closed-form root set that the density
does NOT cover (before start_at / past num_rows - span).
"""

from __future__ import annotations

from typing import List, Tuple

from .constraint import DenseConstraint, RepeatedConstraint, SparseConstraint


def density_key(d) -> Tuple:
    """Hashable batch key; insertion order of these keys drives the
    Fiat-Shamir challenge order (src/ali/per_register/mod.rs:163-171)."""
    if isinstance(d, DenseConstraint):
        return ("dense", d.start_at, d.span)
    if isinstance(d, RepeatedConstraint):
        return ("repeated", d.start_at, d.span, d.interval)
    if isinstance(d, SparseConstraint):
        return ("sparse", d.rows)
    raise TypeError(f"unknown density {d!r}")


def density_active_rows(key: Tuple, num_rows: int) -> List[int]:
    """Rows at which a constraint with this density must hold."""
    kind = key[0]
    if kind == "dense":
        _, start, span = key
        return list(range(start, max(num_rows - span, start)))
    if kind == "repeated":
        _, start, span, interval = key
        return [r for r in range(start, max(num_rows - span, 0), interval)]
    _, rows = key
    return list(rows)


def density_divisor_spec(key: Tuple, domain_size: int, num_rows: int):
    """Device-friendly divisor description.

    Returns (exponent, constant_exp, excluded_row_exps, included_row_exps):

      exponent > 0: Z = (X^exponent - g^constant_exp) /
                        prod_{r in excluded}(X - g^r)
      exponent == 0 (sparse): Z = prod_{r in included}(X - g^r)

    All roots are given as exponents of the column-domain generator g.
    """
    kind = key[0]
    if kind == "dense":
        _, start, span = key
        excluded = list(range(start)) + list(range(num_rows - span, domain_size))
        return domain_size, 0, excluded, []
    if kind == "repeated":
        _, start, span, interval = key
        if interval & (interval - 1) or not (0 < interval <= domain_size):
            raise ValueError(
                f"repeated density interval {interval} must be a power of two "
                f"dividing the column domain size {domain_size}"
            )
        if start >= domain_size:
            raise ValueError(f"repeated density start_at {start} >= domain {domain_size}")
        e = domain_size // interval
        excluded = [
            r
            for r in range(start % interval, domain_size, interval)
            if r < start or r >= num_rows - span
        ]
        return e, (start % interval) * e, excluded, []
    _, rows = key
    if not rows:
        raise ValueError("sparse density needs at least one row")
    if len(set(rows)) != len(rows):
        raise ValueError("sparse density rows must be distinct")
    if max(rows) >= num_rows or min(rows) < 0:
        raise ValueError(f"sparse density rows {rows} out of range [0, {num_rows})")
    return 0, 0, [], list(rows)


def inverse_divisor_at(field, x: int, column_domain, key: Tuple, num_rows: int) -> int:
    """Scalar 1/Z_D(x) — the verifier-side evaluation
    (generalizes src/verifier/mod.rs:635-677 to all densities)."""
    from ..errors import DivisionByZeroError

    p = field.p
    g = column_domain.generator
    e, c_exp, excluded, included = density_divisor_spec(
        key, column_domain.size, num_rows
    )
    if e:
        q = (field.pow(x, e) - field.pow(g, c_exp)) % p
    else:
        q = 1
        for r in included:
            q = q * ((x - field.pow(g, r)) % p) % p
    if q == 0:
        raise DivisionByZeroError("no inverse for constraint divisor")
    inv = field.inv(q)
    for r in excluded:
        inv = inv * ((x - field.pow(g, r)) % p) % p
    return inv
