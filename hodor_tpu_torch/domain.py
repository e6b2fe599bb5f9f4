"""Multiplicative 2^k subgroup domains.

Mirrors src/domains/mod.rs: `Domain::new_for_size` squares F::root_of_unity()
down from the field's 2-adicity S (:21-44); the FRI index helpers
`coset_for_natural_index_and_size` (:46-54) and
`index_and_size_for_next_domain` (:56-71) are module functions here.
"""

from __future__ import annotations

import dataclasses

from .errors import SynthesisError
from .field.field import Field


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def log2_floor(n: int) -> int:
    assert n > 0
    return n.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Domain:
    size: int
    power_of_two: int
    generator: int  # canonical int
    field: Field

    @staticmethod
    def new_for_size(field: Field, size: int) -> "Domain":
        size = next_power_of_two(size)
        power_of_two = log2_floor(size)
        if power_of_two > field.S:
            raise SynthesisError(
                f"domain size 2^{power_of_two} exceeds field 2-adicity {field.S}"
            )
        generator = field.root_of_unity
        for _ in range(power_of_two, field.S):
            generator = field.mul(generator, generator)
        return Domain(size=size, power_of_two=power_of_two, generator=generator, field=field)

    @property
    def generator_inv(self) -> int:
        return self.field.inv(self.generator)


def coset_for_natural_index_and_size(natural_index: int, domain_size: int):
    """FRI coset pairing {i, i + N/2}, sorted (src/domains/mod.rs:46-54)."""
    assert domain_size > 1 and domain_size & (domain_size - 1) == 0
    pair = (natural_index + domain_size // 2) % domain_size
    return sorted([natural_index, pair])


def index_and_size_for_next_domain(natural_index: int, domain_size: int):
    """Map a coset index into the next (halved) FRI domain
    (src/domains/mod.rs:56-71)."""
    assert domain_size > 1 and domain_size & (domain_size - 1) == 0
    next_size = domain_size // 2
    next_index = natural_index if natural_index < next_size else natural_index - next_size
    return next_index, next_size
