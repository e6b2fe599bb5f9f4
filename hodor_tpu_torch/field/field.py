"""Field parameters and exact host scalar arithmetic.

Mirrors the semantics of the `ff_ce` `#[derive(PrimeField)]` macro that the
reference relies on (instantiations: src/lib.rs:35-38 for F_257,
src/experiments/mod.rs:18-21 for the 2^251+17*2^192+1 "stark" prime,
src/bn256.rs:4-7 for the BLS12-381 scalar field):

- NUM_BITS   = bit length of the modulus
- CAPACITY   = NUM_BITS - 1
- S, t       : p - 1 = 2^S * t with t odd (2-adicity)
- root_of_unity = generator^t mod p
- n64        = number of u64 repr limbs = ceil(NUM_BITS / 64)
- R          = 2^(64*n64)  (Montgomery radix; raw repr is x*R mod p)

Host values are plain Python ints in canonical form [0, p); Montgomery
form is only used at serialization boundaries (IOP leaf encoding uses the
raw Montgomery repr, src/iop/blake2s_trivial_iop.rs:36-42) and on device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache


@dataclasses.dataclass(frozen=True)
class Field:
    """A prime field F_p with a chosen multiplicative generator."""

    p: int
    generator: int
    name: str = ""

    # ---- derived parameters (ff_ce derive equivalents) ----

    @property
    def num_bits(self) -> int:
        return self.p.bit_length()

    @property
    def capacity(self) -> int:
        # ff: CAPACITY = NUM_BITS - 1
        return self.num_bits - 1

    @property
    def n64(self) -> int:
        return (self.num_bits + 63) // 64

    @property
    def n16(self) -> int:
        # device limb count: 16-bit limbs covering the u64 repr exactly
        return 4 * self.n64

    @property
    def repr_size(self) -> int:
        # bytes of the ff repr (used by transcript commits / leaf encoding)
        return 8 * self.n64

    @property
    def R(self) -> int:
        return 1 << (64 * self.n64)

    @property
    def R_mod_p(self) -> int:
        return self.R % self.p

    @property
    def R2_mod_p(self) -> int:
        return (self.R * self.R) % self.p

    @property
    def p_inv_neg(self) -> int:
        """-p^{-1} mod R (Montgomery reduction constant)."""
        return (-pow(self.p, -1, self.R)) % self.R

    @property
    def S(self) -> int:
        """2-adicity of p-1 (ff: F::S)."""
        s, t = 0, self.p - 1
        while t % 2 == 0:
            s += 1
            t //= 2
        return s

    @property
    def t_odd(self) -> int:
        return (self.p - 1) >> self.S

    @property
    def root_of_unity(self) -> int:
        """2^S-th primitive root of unity (ff: F::root_of_unity())."""
        return pow(self.generator, self.t_odd, self.p)

    # ---- scalar host arithmetic (exact, canonical form) ----

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            from ..errors import DivisionByZeroError

            raise DivisionByZeroError(f"no inverse of 0 in F_{self.p}")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def to_mont(self, a: int) -> int:
        return (a * self.R) % self.p

    def from_mont(self, a_mont: int) -> int:
        return (a_mont * pow(self.R, -1, self.p)) % self.p

    # ---- byte encodings (must match ff_ce PrimeFieldRepr exactly) ----

    def repr_be(self, a: int) -> bytes:
        """Canonical repr, big-endian (ff repr.write_be, highest u64 limb
        first). Used by Transcript.commit_field_element
        (src/transcript/mod.rs:53-57)."""
        return a.to_bytes(self.repr_size, "big")

    def repr_le(self, a: int) -> bytes:
        """Little-endian canonical repr (ff repr.write_le)."""
        return a.to_bytes(self.repr_size, "little")

    def raw_repr_le(self, a: int) -> bytes:
        """Montgomery (raw) repr, little-endian - the IOP leaf encoding
        (src/iop/blake2s_trivial_iop.rs:36-42 uses into_raw_repr + write_le)."""
        return self.to_mont(a).to_bytes(self.repr_size, "little")

    def from_be_with_shave(self, data: bytes) -> int:
        """Decode a challenge from hash output: read repr_size bytes BE from
        the start of `data`, mask the top u64 limb with
        0xffff..ff >> (SHAVE_BITS % 64) where SHAVE_BITS = 256 - CAPACITY.
        Mirrors Blake2sTranscript::get_challenge (src/transcript/mod.rs:60-79)
        and Blake2sLeafEncoder::interpret_hash
        (src/iop/blake2s_trivial_iop.rs:45-61)."""
        shave_bits = 256 - self.capacity
        mask = 0xFFFFFFFFFFFFFFFF >> (shave_bits % 64)
        value = int.from_bytes(data[: self.repr_size], "big")
        top_shift = 64 * (self.n64 - 1)
        top = (value >> top_shift) & mask
        value = (value & ((1 << top_shift) - 1)) | (top << top_shift)
        if value >= self.p:
            from ..errors import InvalidValueError

            raise InvalidValueError("shaved challenge not in field")
        return value

    def __hash__(self):
        return hash((self.p, self.generator))

    def __repr__(self):
        return f"Field({self.name or hex(self.p)})"


# The three fields defined in the reference repo (SURVEY.md section 0):

# src/lib.rs:35-38 - tiny test field
F257 = Field(p=257, generator=3, name="F257")

# src/experiments/mod.rs:18-21 - the benchmark/"production" StarkWare prime
F_STARK = Field(
    p=3618502788666131213697322783095070105623107215331596699973092056135872020481,
    generator=3,
    name="F_STARK",
)

# src/bn256.rs:4-7 - despite the name, the BLS12-381 scalar field
F_BLS = Field(
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    name="F_BLS",
)

# Not in the reference: a 63-bit prime 2147483641*2^32 + 1 (generator 3,
# 2-adicity 32). Added because the framework is generic over the modulus
# anyway and a single-u64-repr field compiles ~16x smaller mul graphs
# than F_STARK (n16 = 4 vs 16), which makes it the right field for
# compile-time-sensitive paths: the multichip dryrun and fast
# CI shapes. Unlike F257 (also 4 limbs) its 2^63 size makes DEEP's
# "mask*z in the LDE domain" collision probability negligible
# (~domain/2^63) where F257 fails outright at useful shapes. 63 bits
# (not the 64-bit Goldilocks prime) because the relaxed Montgomery
# reduce needs num_bits <= 16*n16 - 1: u = (t + m*p)/R < 2p must fit n
# limbs (see LimbOps.__init__'s headroom assertion).
F_P63 = Field(p=2147483641 * (1 << 32) + 1, generator=3, name="F_P63")


@lru_cache(maxsize=None)
def _check(field: Field) -> None:
    assert field.p > 2 and pow(field.generator, field.p - 1, field.p) == 1
