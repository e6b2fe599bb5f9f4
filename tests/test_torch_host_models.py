"""The port's host models and helpers against hodor_tpu's and hashlib:
models/fp2 and models/tensor_lde, utils/poly_scalar and utils/hashers,
and the host Blake2s library (csrc/host/blake2s.cpp through
utils/native.py) against hashlib and against the port's device Merkle
tree on CPU tensors. Host code on Python ints: every result is compared
for equality."""

import hashlib
import random

import numpy as np
import pytest
import torch

import hodor_tpu.models.fp2 as jfp2
import hodor_tpu.models.tensor_lde as jtl
import hodor_tpu.utils.hashers as jhashers
import hodor_tpu.utils.poly_scalar as jps
from hodor_tpu.domain import Domain as JDomain
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK
import hodor_tpu_torch.models.fp2 as fp2
import hodor_tpu_torch.models.tensor_lde as tl
import hodor_tpu_torch.utils.hashers as hashers
import hodor_tpu_torch.utils.poly_scalar as ps
from hodor_tpu_torch.domain import Domain
from hodor_tpu_torch.field import F257, F_STARK, LimbOps
from hodor_tpu_torch.merkle.blake2s import KEY, PERSONAL
from hodor_tpu_torch.merkle.tree import MerkleTree
from hodor_tpu_torch.utils import native

torch.set_num_threads(1)


def _pair(seed):
    rng = random.Random(seed)
    return [(rng.randrange(F_STARK.p), rng.randrange(F_STARK.p)) for _ in range(3)]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fq2_arithmetic_matches_hodor_tpu(seed):
    (a0, a1), (b0, b1), _ = _pair(seed)
    a, b = fp2.Fq2.make(F_STARK, a0, a1), fp2.Fq2.make(F_STARK, b0, b1)
    ja, jb = jfp2.Fq2.make(JF_STARK, a0, a1), jfp2.Fq2.make(JF_STARK, b0, b1)
    for got, want in ((a.mul(b), ja.mul(jb)), (a.square(), ja.square()), (a.add(b), ja.add(jb)),
                      (a.sub(b), ja.sub(jb)), (a.inverse(), ja.inverse()),
                      (a.pow(seed), ja.pow(seed)), (a.frobenius(), ja.frobenius())):
        assert (got.c0, got.c1) == (want.c0, want.c1)
    assert a.norm() == ja.norm()
    sq = a.square()
    r, jr = sq.sqrt(), ja.square().sqrt()
    assert (r.c0, r.c1) == (jr.c0, jr.c1)
    assert r.square() == sq


def test_fq2_zero_inverse_raises():
    from hodor_tpu_torch.errors import DivisionByZeroError

    with pytest.raises(DivisionByZeroError):
        fp2.Fq2.zero(F_STARK).inverse()


@pytest.mark.parametrize("field,jfield", [(F257, JF257), (F_STARK, JF_STARK)],
                         ids=["F257", "F_STARK"])
def test_tonelli_shanks_and_sqrt_chain_match_hodor_tpu(field, jfield):
    rng = random.Random(24)
    for _ in range(8):
        a = rng.randrange(field.p)
        assert fp2.tonelli_shanks(field, a) == jfp2.tonelli_shanks(jfield, a)
    start = fp2.Fq2.make(field, 12345, 6789).square()
    chain = fp2.sqrt_chain(field, (start.c0, start.c1), 1)
    assert chain == jfp2.sqrt_chain(jfield, (start.c0, start.c1), 1)
    for (c0, c1), (n0, n1) in zip(chain, chain[1:]):
        sq = fp2.Fq2.make(field, n0, n1).square()
        assert (sq.c0, sq.c1) == (c0, c1)


def test_tensor_lde_queries_match_hodor_tpu():
    a, b = ([2, 3], 2), ([5, 7, 11], 3)
    for i in range(6):
        assert tl.query_vector_over_vector(F257, a, b, i) == \
            jtl.query_vector_over_vector(JF257, a, b, i)
    sub, diag = ([1, 2, 3, 4], (2, 2)), ([9, 10], 2)
    for r in range(4):
        for c in range(4):
            assert tl.query_matrix_over_identity(F257, sub, (r, c)) == \
                jtl.query_matrix_over_identity(JF257, sub, (r, c))
            assert tl.query_matrix_over_diagonal(F257, sub, diag, (r, c)) == \
                jtl.query_matrix_over_diagonal(JF257, sub, diag, (r, c))


def test_tensor_lde_generator_decomposition_matches_hodor_tpu():
    n = 4 * 16
    gen = Domain.new_for_size(F257, n).generator
    assert gen == JDomain.new_for_size(JF257, n).generator
    f1, f2 = tl.decompose_lde_generator_for_vector_over_vector(F257, 4, 16, (8, 8), gen,
                                                               F257.generator)
    jf1, jf2 = jtl.decompose_lde_generator_for_vector_over_vector(JF257, 4, 16, (8, 8), gen,
                                                                  JF257.generator)
    assert (f1, f2) == (jf1, jf2)
    v1, v2 = tl.materialize_factor(F257, f1), tl.materialize_factor(F257, f2)
    assert (v1, v2) == (jtl.materialize_factor(JF257, jf1), jtl.materialize_factor(JF257, jf2))
    for idx in range(n):
        want = F257.generator * F257.pow(gen, idx) % F257.p
        assert tl.query_vector_over_vector(F257, v1, v2, idx) == want


@pytest.mark.parametrize("n", [1, 4, 9])
def test_poly_scalar_matches_hodor_tpu(n):
    rng = random.Random(n)
    points = [(x, rng.randrange(F_STARK.p)) for x in rng.sample(range(1, 10 ** 6), n)]
    coeffs = ps.interpolate(F_STARK, points)
    assert coeffs == jps.interpolate(JF_STARK, points)
    for x, y in points:
        assert ps.evaluate(F_STARK, coeffs, x) == y == jps.evaluate(JF_STARK, coeffs, x)
    assert ps.evaluate_at_consecutive_powers(F_STARK, coeffs, 7, 3) == \
        jps.evaluate_at_consecutive_powers(JF_STARK, coeffs, 7, 3)


@pytest.mark.parametrize("size", [0, 1, 135, 136, 137, 300])
def test_hashers_match_hodor_tpu_and_hashlib(size):
    data = bytes(random.Random(size).randrange(256) for _ in range(size))
    k, jk = hashers.Keccak256Hasher(), jhashers.Keccak256Hasher()
    s = hashers.Sha256Hasher()
    for h in (k, jk, s):
        h.update(data[:size // 2])
        h.update(data[size // 2:])
    digest = k.finalize()
    assert digest == jk.finalize()
    assert s.finalize() == hashlib.sha256(data).digest()
    if size == 0:  # the published Keccak-256 of the empty string
        assert digest.hex() == \
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


def test_host_blake2s_matches_hashlib():
    for msg in (b"", b"a", b"x" * 32, b"y" * 64, b"z" * 100):
        assert native.blake2s_keyed(msg) == hashlib.blake2s(msg, key=KEY, person=PERSONAL).digest()


@pytest.mark.parametrize("field", [F257, F_STARK], ids=lambda f: f.name)
def test_host_blake2s_tree_matches_the_device_tree(field):
    ops = LimbOps(field, "cpu")
    vals = [pow(5, i, field.p) for i in range(64)]
    tree = MerkleTree.create(ops.encode(vals), field)
    leaves = b"".join(field.raw_repr_le(v).ljust(32, b"\x00") for v in vals)
    leaf_hashes, nodes = native.build_tree(leaves, 64)
    assert nodes[32:64] == tree.get_root()
    assert leaf_hashes == native.hash_leaves(leaves, 64)
    want = tree.leaf_hashes.numpy().astype(np.int64) & 0xFFFFFFFF
    assert leaf_hashes == want.astype("<u4").tobytes()
    arr = np.array(vals, dtype=object)
    for i in (0, 13, 63):
        q = tree.query(i, arr)
        leaf32 = field.raw_repr_le(q.value).ljust(32, b"\x00")
        assert native.verify_path(tree.get_root(), leaf32, q.path, i)
        assert not native.verify_path(tree.get_root(), leaf32, q.path, i ^ 1)


def test_host_blake2s_library_checks_lengths():
    leaf = bytes(32)
    with pytest.raises(ValueError):
        native.hash_leaves(bytes(63), 2)
    with pytest.raises(ValueError):
        native.build_tree(bytes(32 * 3), 3)
    with pytest.raises(ValueError):
        native.verify_path(bytes(31), leaf, [leaf], 0)
    with pytest.raises(ValueError):
        native.verify_path(leaf, leaf, [bytes(16)], 0)
