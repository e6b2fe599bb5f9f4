"""Proof (de)serialization: a canonical little-endian byte format.

The reference lists "Serialization formats" as unfinished (README.md
feature list); proofs there are in-memory structs only. This module
defines a simple canonical format so proofs can be persisted and
exchanged:

  header:   magic "HTPU" | u32 version | u32 repr_size
  ints:     canonical field elements, repr_size bytes LE
  hashes:   32 bytes
  vectors:  u32 length prefix
  queries:  u64 index | element | u32 path_len | path hashes
  layout:   f_at_z_m, f_iop_roots, g_iop_root, f_queries, g_query,
            h1_iop_roots, h2_iop_roots, fri_proof_h1, fri_proof_h2
  fri:      u32 idpo | u32 ocadpo | u32 lde_factor | queries | roots |
            final_coefficients
"""

from __future__ import annotations

import io
import struct
from typing import List

from .errors import InvalidValueError
from .field.field import Field
from .fri import FRIProof
from .merkle.tree import IopQuery
from .prover import InstanceProof

MAGIC = b"HTPU"
VERSION = 1


class _Writer:
    def __init__(self, field: Field):
        self.buf = io.BytesIO()
        self.field = field

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", v))

    def element(self, v: int):
        self.buf.write(self.field.repr_le(v % self.field.p))

    def hash32(self, h: bytes):
        assert len(h) == 32
        self.buf.write(h)

    def elements(self, vs: List[int]):
        self.u32(len(vs))
        for v in vs:
            self.element(v)

    def hashes(self, hs: List[bytes]):
        self.u32(len(hs))
        for h in hs:
            self.hash32(h)

    def query(self, q: IopQuery):
        self.u64(q.index)
        self.element(q.value)
        self.u32(len(q.path))
        for h in q.path:
            self.hash32(h)

    def fri_proof(self, fp: FRIProof):
        self.u32(fp.initial_degree_plus_one)
        self.u32(fp.output_coeffs_at_degree_plus_one)
        self.u32(fp.lde_factor)
        self.u32(len(fp.queries))
        for q in fp.queries:
            self.query(q)
        self.hashes(fp.roots)
        self.elements(fp.final_coefficients)


class _Reader:
    def __init__(self, data: bytes, field: Field):
        self.buf = io.BytesIO(data)
        self.field = field

    def _read(self, n: int) -> bytes:
        b = self.buf.read(n)
        if len(b) != n:
            raise InvalidValueError("truncated proof")
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def element(self) -> int:
        v = int.from_bytes(self._read(self.field.repr_size), "little")
        if v >= self.field.p:
            raise InvalidValueError("element out of field")
        return v

    def hash32(self) -> bytes:
        return self._read(32)

    def elements(self) -> List[int]:
        return [self.element() for _ in range(self.u32())]

    def hashes(self) -> List[bytes]:
        return [self.hash32() for _ in range(self.u32())]

    def query(self) -> IopQuery:
        idx = self.u64()
        value = self.element()
        path = [self.hash32() for _ in range(self.u32())]
        return IopQuery(index=idx, value=value, path=path)

    def fri_proof(self) -> FRIProof:
        idpo = self.u32()
        ocadpo = self.u32()
        lde_factor = self.u32()
        queries = [self.query() for _ in range(self.u32())]
        roots = self.hashes()
        final = self.elements()
        return FRIProof(
            queries=queries,
            roots=roots,
            final_coefficients=final,
            initial_degree_plus_one=idpo,
            output_coeffs_at_degree_plus_one=ocadpo,
            lde_factor=lde_factor,
        )


def serialize_proof(proof: InstanceProof, field: Field) -> bytes:
    w = _Writer(field)
    w.buf.write(MAGIC)
    w.u32(VERSION)
    w.u32(field.repr_size)
    w.elements(proof.f_at_z_m)
    w.hashes(proof.f_iop_roots)
    w.hash32(proof.g_iop_root)
    w.u32(len(proof.f_queries))
    for q in proof.f_queries:
        w.query(q)
    w.query(proof.g_query)
    w.hashes(proof.h1_iop_roots)
    w.hashes(proof.h2_iop_roots)
    w.fri_proof(proof.fri_proof_h1)
    w.fri_proof(proof.fri_proof_h2)
    return w.buf.getvalue()


def deserialize_proof(data: bytes, field: Field) -> InstanceProof:
    r = _Reader(data, field)
    if r._read(4) != MAGIC:
        raise InvalidValueError("bad magic")
    if r.u32() != VERSION:
        raise InvalidValueError("unsupported version")
    if r.u32() != field.repr_size:
        raise InvalidValueError("field repr size mismatch")
    f_at_z_m = r.elements()
    f_iop_roots = r.hashes()
    g_iop_root = r.hash32()
    f_queries = [r.query() for _ in range(r.u32())]
    g_query = r.query()
    h1_iop_roots = r.hashes()
    h2_iop_roots = r.hashes()
    fri_h1 = r.fri_proof()
    fri_h2 = r.fri_proof()
    return InstanceProof(
        f_at_z_m=f_at_z_m,
        f_iop_roots=f_iop_roots,
        g_iop_root=g_iop_root,
        f_queries=f_queries,
        g_query=g_query,
        h1_iop_roots=h1_iop_roots,
        h2_iop_roots=h2_iop_roots,
        fri_proof_h1=fri_h1,
        fri_proof_h2=fri_h2,
    )
