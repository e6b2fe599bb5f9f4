"""The fused level's kernel function alone, on CPU tensors: the port's
dft_reduce (its plain version) against the JAX package's pallas_dft_reduce
in interpret mode on the same int8 operands, and the plain walk of the
columns with a running carry (the order of both CUDA bodies) against the
plain fold into relaxed limbs, on the folded DFT matrix and on a random W
that is no fold of anything. Inputs from numpy seeds; tolerance 0
(canonical outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.ntt.matmul as jmm
from hodor_tpu.field import F_STARK as JF_STARK
from hodor_tpu.field.pallas_kernels import LANES, pallas_dft_reduce
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.ntt import matmul as tmm

torch.set_num_threads(1)


def _limbs(rng, shape, field=F_STARK):
    if field.num_bits <= 16:
        limbs = np.zeros(shape + (field.n16,), dtype=np.uint32)
        limbs[..., 0] = rng.integers(0, field.p, size=shape)
        return limbs
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs


def _random_w(rng, planes, size, depth, live_planes):
    """Random int8 W with the top columns at byte 0 (-128), so that
    t = sum_c col[c] 256^c stays below the reduction's bound size * p^2,
    and the sums of its bytes plus 128."""
    w = rng.integers(-128, 128, size=(planes, size, depth), dtype=np.int8)
    w[live_planes:] = -128
    w_sum = (w.astype(np.int32) + 128).sum(axis=-1, dtype=np.int32)
    return torch.from_numpy(w), torch.from_numpy(w_sum)


def _twiddle(rng, tw_case, size, ccols, field=F_STARK):
    if tw_case == "none":
        return None
    shape = () if tw_case == "scalar" else (size, ccols)
    return from_numpy_limbs(_limbs(rng, shape, field), "cpu")


def _pallas(w_s8, w_sum, x_s8, size, tw):
    """pallas_dft_reduce (interpret mode) on the port's operands: x_s8
    (1, M, S P) with M a multiple of 128 lanes, tw None | (n16,) |
    (S, M, n16) -> (1, S, M, n16) uint32."""
    m = x_s8.shape[1]
    planes, _, depth = w_s8.shape
    xj = x_s8[0].numpy().T.reshape(depth, m // LANES, LANES).transpose(1, 0, 2)
    w_sum_b = np.broadcast_to(w_sum.numpy()[:, :, None], (planes, size, LANES)).astype(np.int32)
    tw4 = None
    if tw is not None:
        t = to_numpy_limbs(tw)
        if t.ndim == 1:
            twf = np.broadcast_to(t, (1, LANES, size, 16))
        else:
            twf = t.transpose(1, 0, 2).reshape(m // LANES, LANES, size, 16)
        tw4 = jnp.asarray(np.ascontiguousarray(twf.transpose(0, 3, 2, 1)))
    chain = tuple(tuple(int(v) for v in mult) for mult in jmm._reduction_chain(JF_STARK, size))
    out = pallas_dft_reduce(JF_STARK, jnp.asarray(w_s8.numpy()), jnp.asarray(w_sum_b),
                            jnp.asarray(np.ascontiguousarray(xj)), chain, tw4, interpret=True)
    # (m_tiles, n16, S, LANES) -> (1, S, M, n16)
    return np.asarray(out).transpose(2, 0, 3, 1).reshape(size, m, 16)[None]


@pytest.mark.parametrize("tw_case", ["none", "scalar", "table"])
@pytest.mark.parametrize("size", [32, 128])
def test_dft_reduce_plain_matches_pallas_dft_reduce(size, tw_case):
    rng = np.random.default_rng(100 * size + len(tw_case))
    ops = LimbOps(F_STARK, "cpu")
    x = from_numpy_limbs(_limbs(rng, (1, size, LANES)), "cpu")  # (B, S, C)
    tw = _twiddle(rng, tw_case, size, LANES)
    w_s8, w_sum = tmm.folded_dft_matrix(ops, size, False)
    x_s8 = tmm.encode_s8(x).contiguous()
    got = K.dft_reduce(F_STARK, w_s8, w_sum, x_s8, size, tw)
    assert got.dtype == torch.int32 and got.shape == (1, size, LANES, 16)
    assert np.array_equal(to_numpy_limbs(got), _pallas(w_s8, w_sum, x_s8, size, tw))
    assert torch.equal(got, K.ntt_level_plain(F_STARK, x, tmm.dft_matrix(ops, size, False), tw))


def test_dft_reduce_plain_matches_pallas_on_a_random_w():
    """W need not be a fold of a DFT matrix: any int8 with its sums."""
    rng = np.random.default_rng(77)
    size = 32
    x_s8 = torch.from_numpy(rng.integers(-128, 128, size=(1, LANES, size * 32), dtype=np.int8))
    w_s8, w_sum = _random_w(rng, 63, size, size * 32, 60)
    tw = _twiddle(rng, "table", size, LANES)
    got = K.dft_reduce(F_STARK, w_s8, w_sum, x_s8, size, tw)
    assert np.array_equal(to_numpy_limbs(got), _pallas(w_s8, w_sum, x_s8, size, tw))


CARRY_CASES = [("F_STARK", 128, 3, 20, "table"), ("F_STARK", 128, 1, 1, "none"),
               ("F_STARK", 32, 7, 5, "scalar"), ("F_STARK", 8, 2, 3, "table"),
               ("F257", 128, 5, 9, "none"), ("F257", 16, 3, 4, "scalar")]


@pytest.mark.parametrize("name,size,bsz,ccols,tw_case", CARRY_CASES)
def test_column_walk_with_carry_matches_the_relaxed_fold(name, size, bsz, ccols, tw_case):
    field = {"F_STARK": F_STARK, "F257": F257}[name]
    rng = np.random.default_rng(size + bsz)
    ops = LimbOps(field, "cpu")
    x = from_numpy_limbs(_limbs(rng, (bsz, size, ccols), field), "cpu")
    tw = _twiddle(rng, tw_case, size, ccols, field)
    w_s8, w_sum = tmm.folded_dft_matrix(ops, size, False)
    x_s8 = tmm.encode_s8(x).contiguous()
    want = K.dft_reduce_plain(field, w_s8, w_sum, x_s8, size, tw)
    assert torch.equal(K.dft_reduce_carry_plain(field, w_s8, w_sum, x_s8, size, tw), want)
    assert torch.equal(want, K.ntt_level_plain(field, x, tmm.dft_matrix(ops, size, False), tw))


@pytest.mark.parametrize("size,tw_case", [(128, "table"), (64, "none"), (32, "scalar")])
def test_random_w_through_both_plain_versions(size, tw_case):
    rng = np.random.default_rng(size)
    bsz, ccols, depth = 2, 5, size * 32
    x_s8 = torch.from_numpy(rng.integers(-128, 128, size=(bsz, ccols, depth), dtype=np.int8))
    w_s8, w_sum = _random_w(rng, 63, size, depth, 60)
    tw = _twiddle(rng, tw_case, size, ccols)
    cols = K.dft_columns_plain(w_s8, w_sum, x_s8)
    exact = (w_s8.to(torch.int64) + 128).reshape(-1, depth) @ \
        (x_s8.to(torch.int64) + 128).reshape(-1, depth).t()
    assert torch.equal(cols.to(torch.int64), exact.reshape(63, size, bsz, ccols))
    want = K.wide_reduce_plain(F_STARK, cols, size, tw)
    assert torch.equal(K.dft_reduce(F_STARK, w_s8, w_sum, x_s8, size, tw), want)
    assert torch.equal(K.dft_reduce_carry_plain(F_STARK, w_s8, w_sum, x_s8, size, tw), want)


def test_dft_reduce_body_is_picked_from_field_and_radix():
    assert [K.dft_reduce_body(F_STARK, s) for s in (128, 64, 32, 16, 1)] == \
        ["mma", "mma", "mma", "dp4a", "dp4a"]
    assert K.dft_reduce_body(F257, 128) == "dp4a"
    with pytest.raises(ValueError):
        K.dft_reduce_body(F_STARK, 256)
    K.reset_launch_counts()
    assert K.dft_reduce_body_counts == {"mma": 0, "dp4a": 0}
