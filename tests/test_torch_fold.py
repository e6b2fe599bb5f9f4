"""The port's FRI fold (hodor_tpu_torch.fri.fri.fold_round, which on CPU
tensors runs the fri_fold kernel's plain version: the challenge drawn
from a root digest, the twiddles from two inverse-root tables) against
the JAX package's fold with its Pallas fold kernel in interpret mode and
with the kernel off, and against the ladder's old composition
(digest_to_challenge_mont, ops.powers, fri_fold_plain), on the same
numpy-seeded inputs. Tolerance 0: every output is canonical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.fri.fri as jfri
from hodor_tpu.field import F_STARK as JF_STARK, ops_for
from hodor_tpu_torch.domain import Domain
from hodor_tpu_torch.field import (F257, F_BLS, F_P63, F_STARK, LimbOps, from_numpy_limbs,
                                   to_numpy_limbs)
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.field.limbs import int_to_limbs
from hodor_tpu_torch.fri import fri as tfri
from hodor_tpu_torch.fri.fri import fold_pair_composed, fold_round, fold_twiddles, fri_chain
from hodor_tpu_torch.merkle import blake2s as tblake2s
from hodor_tpu_torch.merkle.blake2s import digest_to_challenge_mont

torch.set_num_threads(1)

LOG_DOMAIN = 13


def _limbs(rng, shape):
    """Uniform canonical F_STARK limbs (the top limb cut below p's top bit)."""
    limbs = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.uint32)
    limbs[..., -1] &= 0x7FF
    return limbs


def _roots(rng, shape=()):
    """Random root digests: (..., 8) int32 words, every bit pattern."""
    return torch.from_numpy(
        rng.integers(-1 << 31, 1 << 31, size=shape + (8,), dtype=np.int64).astype(np.int32))


def _values(ops, rng, shape):
    field = ops.field
    ints = [int(v) % field.p for v in rng.integers(0, 1 << 62, size=int(np.prod(shape)))]
    return ops.encode(ints).reshape(shape + (field.n16,))


@pytest.mark.parametrize("jax_kernel", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("round_index", [0, 1])
def test_fold_round_matches_jax(round_index, jax_kernel):
    """Round i folds a 2^(13-i)-element vector with stride 2^i; round 0 is
    large enough for the Pallas kernel's tiles. The JAX fold takes the
    challenge the root draws on the host."""
    rng = np.random.default_rng(47)
    values = _limbs(rng, (1 << (LOG_DOMAIN - round_index),))
    root = _roots(rng)
    c = F_STARK.from_be_with_shave(root.numpy().astype("<i4").tobytes())
    challenge = int_to_limbs(F_STARK.to_mont(c), 16)
    stride = 1 << round_index
    old = jfri._FORCE_PALLAS
    try:
        jfri._FORCE_PALLAS = jax_kernel
        want = np.asarray(jfri._fold_round_body(
            ops_for(JF_STARK), jnp.asarray(values), jnp.asarray(challenge), stride, LOG_DOMAIN))
    finally:
        jfri._FORCE_PALLAS = old
    ops = LimbOps(F_STARK, "cpu")
    got = fold_round(ops, from_numpy_limbs(values, "cpu"), root, stride, LOG_DOMAIN)
    assert got.dtype == torch.int32
    assert np.array_equal(to_numpy_limbs(got), want)


@pytest.mark.parametrize("field", [F_STARK, F257], ids=lambda f: f.name)
@pytest.mark.parametrize("half", [1, 3, 64])
def test_fri_fold_equals_the_elementwise_fold(field, half):
    """The fused association equals (lo + hi + c w (lo - hi)) / 2 on the
    separate add, sub and mul, with c the root's challenge and w_j =
    W^(-j) from ops.powers, also on row-strided views and edge sizes."""
    rng = np.random.default_rng(half)
    ops = LimbOps(field, "cpu")
    values = _values(ops, rng, (2 * half,))
    root = _roots(rng)
    tw = fold_twiddles(ops, 8)
    w = ops.powers(ops.const(Domain.new_for_size(field, 1 << 8).generator_inv), half)
    c = digest_to_challenge_mont(ops, root)
    for lo, hi in ((values[:half], values[half:]), (values[0::2], values[1::2])):
        odd = ops.mul(ops.sub(lo, hi), w)
        want = ops.mul(ops.add(ops.add(lo, hi), ops.mul(odd, c)), ops.two_inv_m)
        got = K.fri_fold(field, lo, hi, root, tw, 1)
        assert torch.equal(got, want)
        out = torch.empty_like(got)
        assert K.fri_fold(field, lo, hi, root, tw, 1, out=out) is out
        assert torch.equal(out, want)


def test_fri_fold_rejects_bad_operands():
    ops = LimbOps(F_STARK, "cpu")
    v = ops.encode(list(range(8)))
    root = torch.zeros(8, dtype=torch.int32)
    tw = fold_twiddles(ops, 4)
    with pytest.raises(ValueError):  # halves of different lengths
        K.fri_fold(F_STARK, v[:4], v[4:7], root, tw, 1)
    with pytest.raises(ValueError):  # a root of 7 words
        K.fri_fold(F_STARK, v[:4], v[4:], root[:7], tw, 1)
    with pytest.raises(ValueError):  # lanes' roots without lanes
        K.fri_fold(F_STARK, v[:4], v[4:], root.expand(2, 8).contiguous(), tw, 1)
    with pytest.raises(ValueError):  # a stride that is no power of two
        K.fri_fold(F_STARK, v[:4], v[4:], root, tw, 3)
    with pytest.raises(ValueError):  # a stride beyond the domain
        K.fri_fold(F_STARK, v[:4], v[4:], root, tw, 32)
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:], root, tw, 1, first=-1)
    with pytest.raises(ValueError):  # a table of limbs, not packed words
        K.fri_fold(F_STARK, v[:4], v[4:], root, K.PowerTwiddle(v[:4], tw.hi, 2), 1)
    with pytest.raises(TypeError):
        K.fri_fold(F_STARK, v[:4].to(torch.int64), v[4:], root, tw, 1)


FOLD_CASES = [(name, lanes, first, log_k) for name in ("F_STARK", "F_BLS", "F_P63")
              for lanes in (1, 2) for first in (0, 5) for log_k in (1, 4, 8, 12)]


@pytest.mark.parametrize("name,lanes,first,log_k", FOLD_CASES)
def test_fold_plain_equals_the_old_composition(name, lanes, first, log_k):
    """The kernel's plain version (`kernels.fri_fold` on CPU tensors: c
    from the roots, W^(-e) from the two tables) against the ladder's old
    composition, lane by lane: K = 2^log_k values in round log_k % 3 of a
    domain of K 2^round points, rows from `first` on as a mesh block's."""
    field = {"F_STARK": F_STARK, "F_BLS": F_BLS, "F_P63": F_P63}[name]
    rng = np.random.default_rng(1000 * log_k + 10 * lanes + first)
    ops = LimbOps(field, "cpu")
    rnd = log_k % 3
    log_domain = log_k + rnd
    half = 1 << (log_k - 1)
    values = _values(ops, rng, (lanes, 2 * half))
    roots = _roots(rng, (lanes,))
    roots[-1, :4] = -1  # every bit of the words the challenge reads: the shave mask's
    lo, hi = values[:, :half], values[:, half:]
    got = K.fri_fold(field, lo, hi, roots, fold_twiddles(ops, log_domain),
                     1 << rnd, first)
    assert got.shape == (lanes, half, field.n16)
    for b in range(lanes):
        want = fold_pair_composed(ops, lo[b], hi[b], roots[b], 1 << rnd, log_domain, first)
        assert torch.equal(got[b], want)


@pytest.mark.parametrize("log_n", [1, 2, 5, 12])
@pytest.mark.parametrize("field", [F_STARK, F_P63], ids=lambda f: f.name)
def test_fold_tables_give_every_inverse_root(field, log_n):
    """The fold's two tables (the NTT plan's inverse power twiddles) give
    W^-e for every e < N, against the host's powers of the generator."""
    ops = LimbOps(field, "cpu")
    tw = fold_twiddles(ops, log_n)
    w_inv = Domain.new_for_size(field, 1 << log_n).generator_inv
    want = [field.pow(w_inv, e) for e in range(1 << log_n)]
    got = ops.decode(K.fold_twiddles_plain(field, tw, 1 << log_n, 1))
    assert list(got) == want


@pytest.mark.parametrize("field", [F_STARK, F_BLS, F_P63, F257], ids=lambda f: f.name)
def test_fold_challenge_is_the_hosts(field):
    """The kernel's challenge derivation in torch ops equals the host's
    Field.from_be_with_shave of the root's bytes and the device form the
    old ladder used, on random digests and on all ones."""
    rng = np.random.default_rng(7)
    ops = LimbOps(field, "cpu")
    roots = torch.cat([_roots(rng, (16,)), torch.full((1, 8), -1, dtype=torch.int32)])
    got = K.fold_challenge_plain(field, roots)
    assert torch.equal(got, digest_to_challenge_mont(ops, roots))
    for r, c in zip(roots, ops.decode(got)):
        assert c == field.from_be_with_shave(r.numpy().astype("<i4").tobytes())


@pytest.mark.parametrize("lanes", [None, 2])
def test_warm_ladder_asks_nothing_of_the_host(lanes, monkeypatch):
    """Once its tables are built, a ladder makes no host-to-device
    constant, no `powers` table and no separate challenge: a round is one
    fold and one tree. The proof parts equal the ladder's before."""
    rng = np.random.default_rng(3)
    ops = LimbOps(F_STARK, "cpu")
    lde = _values(ops, rng, (64,) if lanes is None else (lanes, 64))
    want = fri_chain(ops, lde, 5, 6)

    def refuse(*args, **kwargs):
        raise AssertionError("the ladder asked the host")

    monkeypatch.setattr(LimbOps, "powers", refuse)
    monkeypatch.setattr(LimbOps, "const", refuse)
    monkeypatch.setattr(LimbOps, "encode", refuse)
    monkeypatch.setattr(tblake2s, "digest_to_challenge_mont", refuse)
    monkeypatch.setattr(tfri, "digest_to_challenge_mont", refuse)
    trees, inter, coeffs = fri_chain(ops, lde, 5, 6)
    assert [t.root_digest().tolist() for t in trees] == \
        [t.root_digest().tolist() for t in want[0]]
    assert all(torch.equal(a, b) for a, b in zip(inter, want[1]))
    assert torch.equal(coeffs, want[2])
