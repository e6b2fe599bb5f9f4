"""The two other forms of the NTT level, "two_step" (int8 product, then
the wide_reduce kernel) and "fused" (the dft_reduce kernel), on CPU
tensors, where each kernel wrapper runs its plain version: against the
JAX package's wide-reduce kernel (interpret mode) and jnp reduction on
the same columns, against its fused and two-step levels on the same x
and twiddles, and against the port's own "level" form. Inputs from numpy
seeds; tolerance 0 (canonical outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.ntt.matmul as jmm
from hodor_tpu.field import F_STARK as JF_STARK, ops_for
from hodor_tpu.field.pallas_kernels import pallas_wide_reduce
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.ntt import intt, ntt
from hodor_tpu_torch.ntt import matmul as tmm

torch.set_num_threads(1)

IMPLS = ("level", "two_step", "fused")


def _limbs(rng, shape, field=F_STARK):
    """Uniform canonical limbs: below p's top bit, or below p itself for a
    field of one limb."""
    if field.num_bits <= 16:
        limbs = np.zeros(shape + (field.n16,), dtype=np.uint32)
        limbs[..., 0] = rng.integers(0, field.p, size=shape)
        return limbs
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs


def _columns(ops, x, size):
    """Exact base-256 columns (C, S, B, Cc) of the size-S level of x."""
    w_s8, w_sum = tmm.folded_dft_matrix(ops, size, False)
    return K.dft_columns_plain(w_s8, w_sum, tmm.encode_s8(x))


@pytest.mark.parametrize("with_tw", [False, True], ids=["no_twiddle", "twiddle"])
def test_wide_reduce_plain_matches_jax(with_tw):
    """4096 elements (S = 128, B = 2, C = 16): the Pallas kernel's tile."""
    rng = np.random.default_rng(31)
    size, bsz, ccols = 128, 2, 16
    ops = LimbOps(F_STARK, "cpu")
    jops = ops_for(JF_STARK)
    x = from_numpy_limbs(_limbs(rng, (bsz, size, ccols)), "cpu")
    tw = _limbs(rng, (size, ccols)) if with_tw else None
    cols = _columns(ops, x, size)
    assert cols.dtype == torch.int32 and int(cols.min()) >= 0
    got = to_numpy_limbs(K.wide_reduce(
        F_STARK, cols, size, None if tw is None else from_numpy_limbs(tw, "cpu")))

    cols_np = cols.numpy().astype(np.uint32)  # (C, S, B, Cc), element order (k, b, c)
    total = size * bsz * ccols
    chain = tuple(tuple(int(v) for v in m) for m in jmm._reduction_chain(JF_STARK, size))
    tw_e = None if tw is None else np.broadcast_to(tw[:, None], (size, bsz, ccols, 16))
    tw3 = None if tw is None else jnp.asarray(
        np.ascontiguousarray(tw_e.reshape(total, 16).T).reshape(16, total // 128, 128))
    out3 = pallas_wide_reduce(JF_STARK, jnp.asarray(cols_np.reshape(-1, total // 128, 128)),
                              chain, tw3, interpret=True)
    pallas = np.asarray(out3).reshape(16, size, bsz, ccols).transpose(2, 1, 3, 0)
    assert np.array_equal(got, pallas)

    wide = jmm._mont_reduce_wide(jops, jnp.asarray(cols_np.transpose(1, 2, 3, 0)), size)
    if tw is not None:
        wide = jops.mul(wide, jnp.asarray(np.ascontiguousarray(tw_e)))
    assert np.array_equal(got, np.asarray(wide).transpose(1, 0, 2, 3))


def test_wide_reduce_rejects_negative_and_misshapen_columns():
    ops = LimbOps(F_STARK, "cpu")
    x = from_numpy_limbs(_limbs(np.random.default_rng(1), (1, 2, 3)), "cpu")
    cols = _columns(ops, x, 2)
    bad = cols.clone()
    bad[0, 0, 0, 0] = -1
    with pytest.raises(ValueError):
        K.wide_reduce(F_STARK, bad, 2)
    with pytest.raises(ValueError):
        K.wide_reduce(F_STARK, cols[:-1], 2)
    with pytest.raises(ValueError):
        K.wide_reduce(F_STARK, cols, 2, tw=x[0, :, :2])


@pytest.mark.parametrize("tw_case", ["none", "table"])
def test_levels_match_jax_fused_and_two_step(tw_case):
    """One batch of 128 size-128 DFTs, as the JAX package's own test of its
    fused kernel: the JAX level's (m, k) axes are the port's (c, k)."""
    rng = np.random.default_rng(17)
    x = _limbs(rng, (128, 128))  # [m, j]
    tw = _limbs(rng, (128, 128)) if tw_case == "table" else None  # [m, k]
    jops = ops_for(JF_STARK)
    jtw = None if tw is None else jnp.asarray(tw)
    old = (jmm._FORCE_FUSED, jmm._FUSED_IMPL, jmm._FORCE_PALLAS)
    try:
        jmm._FORCE_FUSED, jmm._FORCE_PALLAS = False, False
        two_step = np.asarray(jmm._dft_matmul(jops, jnp.asarray(x), 128, False, tw=jtw))
        jmm._FORCE_FUSED, jmm._FUSED_IMPL = "interpret", "s8"
        fused = np.asarray(jmm._dft_matmul(jops, jnp.asarray(x), 128, False, tw=jtw))
    finally:
        jmm._FORCE_FUSED, jmm._FUSED_IMPL, jmm._FORCE_PALLAS = old
    assert np.array_equal(two_step, fused)
    xt = from_numpy_limbs(np.ascontiguousarray(x.transpose(1, 0, 2))[None], "cpu")  # (1, S, C)
    twt = None if tw is None else from_numpy_limbs(
        np.ascontiguousarray(tw.transpose(1, 0, 2)), "cpu")  # (S, C)
    for impl in IMPLS:
        got = tmm.dft_level(LimbOps(F_STARK, "cpu", impl), xt, False, twt)
        assert np.array_equal(to_numpy_limbs(got)[0].transpose(1, 0, 2), fused), impl


@pytest.mark.parametrize("field,log_n", [(F_STARK, 8), (F_STARK, 11), (F_STARK, 14), (F257, 8)],
                         ids=lambda v: getattr(v, "name", v))
def test_ntt_and_intt_agree_under_every_impl(field, log_n):
    x = from_numpy_limbs(_limbs(np.random.default_rng(log_n), (1 << log_n,), field), "cpu")
    want = None
    for impl in IMPLS:
        ops = LimbOps(field, "cpu", impl)
        got = (ntt(ops, x), intt(ops, x))
        want = want or got
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), impl


def test_two_step_level_splits_large_batches(monkeypatch):
    """With the split forced at 256 elements, over the batch and over the
    columns of one batch entry, the limbs do not change."""
    rng = np.random.default_rng(5)
    x = from_numpy_limbs(_limbs(rng, (3, 1 << 10)), "cpu")
    want = (ntt(LimbOps(F_STARK, "cpu"), x), intt(LimbOps(F_STARK, "cpu"), x))
    monkeypatch.setattr(tmm, "TWO_STEP_MAX_ELEMENTS", 256)
    ops = LimbOps(F_STARK, "cpu", "two_step")
    assert torch.equal(ntt(ops, x), want[0])
    assert torch.equal(intt(ops, x), want[1])


def test_unknown_ntt_impl_is_refused():
    with pytest.raises(ValueError):
        LimbOps(F_STARK, "cpu", "radix2")


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (5, 7, 3)])
def test_s8dot_plain_matches_numpy(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    b = rng.integers(-128, 128, size=(k, n), dtype=np.int8)
    got = K.s8dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


def test_folded_dft_matrix_matches_jax():
    for jfield, field, size in ((JF_STARK, F_STARK, 8),):
        w_s8, w_sum, _ = jmm._dft_matrix_folded_s8(jfield, size, True)
        got_w, got_sum = tmm.folded_dft_matrix(LimbOps(field, "cpu"), size, True)
        assert np.array_equal(got_w.numpy(), w_s8.reshape(got_w.shape))
        assert np.array_equal(got_sum.numpy(), w_sum)
