"""The port's transforms (hodor_tpu_torch.ntt) and Merkle trees against
hodor_tpu.ntt and hodor_tpu.merkle on the same seeded inputs, on CPU
tensors. The JAX functions run under jax.jit; equality is exact."""

import random
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import hodor_tpu.ntt as jntt
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK, ops_for
from hodor_tpu.merkle import blake2s as jb2s
from hodor_tpu.merkle.tree import MerkleTree as JMerkleTree
import hodor_tpu_torch.ntt as tntt
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.merkle import blake2s as tb2s
from hodor_tpu_torch.merkle.tree import MerkleTree, encode_root_into_challenge, verify_path

torch.set_num_threads(1)

FIELDS = {"F_STARK": (F_STARK, JF_STARK), "F257": (F257, JF257)}


def _pair(name, shape, seed):
    """Same seeded Montgomery values for both packages: (port, jax, ints)."""
    field, jfield = FIELDS[name]
    rng = random.Random(seed)
    vals = np.array([rng.randrange(field.p) for _ in range(int(np.prod(shape)))],
                    dtype=object).reshape(shape)
    ja = ops_for(jfield).encode(vals.tolist())
    return from_numpy_limbs(np.asarray(ja), "cpu"), ja, vals


X_EVAL = 123456789
ALL_FNS = ("ntt", "intt", "coset_ntt", "icoset_ntt", "lde", "coset_lde", "evaluate_at")
# (field, log2 size) -> the transforms compared there; the coset forms
# are the plain ones behind a distribute_powers, so the large case skips
# them to keep the JAX compile short
CASES = {("F_STARK", 4): ALL_FNS, ("F257", 5): ALL_FNS,
         ("F_STARK", 10): ("ntt", "intt", "lde", "evaluate_at")}


def _lde_factor(field, log_n):
    return 4 if log_n + 2 <= field.S else 2


def _port_fns(ops, log_n):
    factor = _lde_factor(ops.field, log_n)
    x = ops.const(X_EVAL % ops.field.p)
    return {
        "ntt": lambda t: tntt.ntt(ops, t),
        "intt": lambda t: tntt.intt(ops, t),
        "coset_ntt": lambda t: tntt.coset_ntt(ops, t),
        "icoset_ntt": lambda t: tntt.icoset_ntt(ops, t),
        "lde": lambda t: tntt.lde(ops, t, factor),
        "coset_lde": lambda t: tntt.lde(ops, t, factor, coset=True),
        "evaluate_at": lambda t: tntt.evaluate_at(ops, t[0], x),
    }


@lru_cache(maxsize=None)
def _jax_refs(name, log_n):
    """Every transform of one seeded (2, 2^log_n) input through
    hodor_tpu.ntt, in one jitted program (one compile per case)."""
    field, jfield = FIELDS[name]
    jops = ops_for(jfield)
    factor = _lde_factor(field, log_n)
    _, ja, vals = _pair(name, (2, 1 << log_n), log_n)

    fns = {
        "ntt": lambda a, x: jntt.ntt(jops, a),
        "intt": lambda a, x: jntt.intt(jops, a),
        "coset_ntt": lambda a, x: jntt.coset_ntt(jops, a),
        "icoset_ntt": lambda a, x: jntt.icoset_ntt(jops, a),
        "lde": lambda a, x: jntt.lde(jops, a, factor),
        "coset_lde": lambda a, x: jntt.lde(jops, a, factor, coset=True),
        "evaluate_at": lambda a, x: jntt.evaluate_at(jops, a[0], x),
    }

    def all_refs(a, x):
        return {k: fns[k](a, x) for k in CASES[(name, log_n)]}

    refs = jax.jit(all_refs)(ja, jops.const(X_EVAL % field.p))
    return {k: np.asarray(v) for k, v in refs.items()}, vals


@pytest.mark.parametrize("name,log_n,fn",
                         [(n, k, f) for (n, k), fns in CASES.items() for f in fns])
def test_transform_matches_jax(name, log_n, fn):
    field, _ = FIELDS[name]
    ops = LimbOps(field, "cpu")
    t, _, _ = _pair(name, (2, 1 << log_n), log_n)
    refs, vals = _jax_refs(name, log_n)
    got = _port_fns(ops, log_n)[fn](t)
    assert (to_numpy_limbs(got) == refs[fn]).all()
    if fn == "ntt":
        assert torch.equal(tntt.intt(ops, got), t)
    if fn == "evaluate_at":
        x = X_EVAL % field.p
        assert ops.decode(got) == sum(
            int(c) * pow(x, i, field.p) for i, c in enumerate(vals[0])) % field.p


@pytest.mark.parametrize("name,log_n", [("F_STARK", 4), ("F_STARK", 10), ("F257", 5)])
def test_merkle_roots_and_paths_match_jax(name, log_n):
    field, jfield = FIELDS[name]
    t, ja, vals = _pair(name, (1 << log_n,), 300 + log_n)
    words = tb2s.limbs_to_leaf_words(t)
    assert (words.numpy().view(np.uint32) == np.asarray(jb2s.limbs_to_leaf_words(ja))).all()
    tree = MerkleTree.create(t, field)
    jtree = JMerkleTree.create(ja, jfield)
    assert tree.get_root() == jtree.get_root()
    assert tree.get_challenge_scalar_from_root() == jtree.get_challenge_scalar_from_root()
    for idx in (0, 1, (1 << log_n) - 1, (1 << log_n) // 3):
        path = tree.get_path(idx)
        assert path == jtree.get_path(idx)
        assert verify_path(tree.get_root(), int(vals[idx]), path, idx, field)
        assert not verify_path(tree.get_root(), (int(vals[idx]) + 1) % field.p, path, idx, field)
        assert tree.query(idx, vals).path == path


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_digest_to_challenge_matches_jax_and_host(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    rng = np.random.default_rng(11)
    for _ in range(4):
        d = rng.integers(0, 1 << 32, size=(8,), dtype=np.uint64).astype(np.uint32)
        got = tb2s.digest_to_challenge_mont(ops, torch.from_numpy(d.view(np.int32)))
        ref = np.asarray(jax.jit(lambda x: jb2s.digest_to_challenge_mont(jops, x))(d))
        assert (to_numpy_limbs(got) == ref).all()
        raw = tb2s.digest_to_bytes(torch.from_numpy(d.view(np.int32)))
        assert raw == jb2s.digest_to_bytes(d)
        assert ops.decode(got) == encode_root_into_challenge(raw, field)


def test_hash_nodes_and_leaves_match_hashlib():
    rng = np.random.default_rng(12)
    left = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 8), dtype=np.int64)
                            .astype(np.int32))
    right = left.flip(0)
    parents = tb2s.hash_nodes(left, right)
    leaves = tb2s.hash_leaves(left)
    for i in range(3):
        lb, rb = tb2s.digest_to_bytes(left[i]), tb2s.digest_to_bytes(right[i])
        assert tb2s.digest_to_bytes(parents[i]) == tb2s.blake2s_keyed(lb + rb)
        assert tb2s.digest_to_bytes(leaves[i]) == tb2s.blake2s_keyed(lb)
