"""Fiat-Shamir transcript: keyed Blake2s rolling state.

Byte-exact port of Blake2sTranscript (src/transcript/mod.rs:20-79):

- state = keyed Blake2s (key b"Squeamish Ossifrage", personal b"Shaftoe",
  32-byte digest), updated incrementally;
- commit_bytes: update(bytes);
- commit_field_element: update(canonical repr, big-endian, repr_size bytes);
- get_challenge_bytes: d = finalize(state) (non-destructive), then
  state.update(d); returns d;
- get_challenge: same d, then decode: read repr_size bytes BE from the
  START of d, mask the top u64 limb with 0xff..ff >> ((256-CAPACITY) % 64).

The transcript is tiny host-side scalar work on hashlib. It keeps every
byte it absorbed, so that it can be snapshotted into a prove checkpoint
(checkpoint.py) and restored, in the JSON form of hodor_tpu/transcript.py.
"""

from __future__ import annotations

import hashlib

from .field.field import Field
from .merkle.blake2s import KEY, PERSONAL


class Blake2sTranscript:
    """Rolling blake2s state via hashlib .copy() - each challenge costs
    one state clone + finalize instead of re-hashing the whole
    accumulated buffer (incremental updates hash the same byte stream,
    so digests equal the reference's rolling blake2s_simd state)."""

    def __init__(self, field: Field):
        assert field.num_bits < 256
        self.field = field
        self._state = hashlib.blake2s(key=KEY, person=PERSONAL)
        # every byte ever absorbed, in order: the state is a pure function
        # of this stream, which makes transcripts checkpoint/restorable
        # (hashlib objects cannot be pickled) - a few KB a prove
        self._raw = bytearray()
        # every challenge drawn, in order - the Fiat-Shamir audit trail
        # golden-vector tests freeze (tests/test_golden.py)
        self.log: list = []

    def _finalize(self) -> bytes:
        return self._state.copy().digest()

    def _absorb(self, data: bytes) -> None:
        self._state.update(data)
        self._raw += data

    def commit_bytes(self, data: bytes) -> None:
        self._absorb(data)

    def commit_field_element(self, value: int) -> None:
        self._absorb(self.field.repr_be(value % self.field.p))

    def get_challenge_bytes(self) -> bytes:
        d = self._finalize()
        self._absorb(d)
        self.log.append(("bytes", d.hex()))
        return d

    def get_challenge(self) -> int:
        d = self._finalize()
        self._absorb(d)
        c = self.field.from_be_with_shave(d)
        self.log.append(("field", c))
        return c

    def clone(self) -> "Blake2sTranscript":
        t = Blake2sTranscript(self.field)
        t._state = self._state.copy()
        t._raw = bytearray(self._raw)
        t.log = list(self.log)
        return t

    # ------------------------------------------------ checkpoint/resume

    def snapshot(self) -> dict:
        """JSON-serializable state (checkpoint.py): the absorbed byte
        stream plus the audit log."""
        return {
            "raw": bytes(self._raw).hex(),
            "log": [[k, v if isinstance(v, str) else str(v)] for k, v in self.log],
        }

    @classmethod
    def restore(cls, field: Field, snap: dict) -> "Blake2sTranscript":
        t = cls(field)
        t._absorb(bytes.fromhex(snap["raw"]))
        t.log = [(k, v if k == "bytes" else int(v)) for k, v in snap["log"]]
        return t


def bytes_to_challenge_index(challenge_bytes: bytes, lde_size: int, lde_factor: int) -> int:
    """Reference Verifier::bytes_to_challenge_index
    (src/verifier/mod.rs:246-263): take the LAST 8 bytes BE as u64, mod
    lde_size, bump off multiples of lde_factor and even indices."""
    idx = int.from_bytes(challenge_bytes[-8:], "big") % lde_size
    if idx % lde_factor == 0:
        idx = (idx + 1) % lde_size
    if idx % 2 == 0:
        idx = (idx + 1) % lde_size
    return idx
