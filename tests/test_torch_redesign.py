"""The plain versions behind the kernels redesigned for the H100 (the
tensor-core body of ntt_level and the mont_pow entry of mont_mul) on CPU
tensors, against the port's own limb level, the JAX package's level
(hodor_tpu.ntt.matmul._dft_matmul through its plain jnp reference) and its
LimbOps.inv_fermat / pow_static on the same limbs. Inputs from numpy seeds;
tolerance 0 (canonical outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.ntt.matmul as jmm
from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK, ops_for
from hodor_tpu_torch.field import (F257, F_BLS, F_P63, F_STARK, LimbOps, from_numpy_limbs,
                                   to_numpy_limbs)
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.field.limbs import pack_ints
from hodor_tpu_torch.ntt import matmul as tmm

torch.set_num_threads(1)

FIELDS = {"F_STARK": (F_STARK, JF_STARK), "F257": (F257, JF257)}


def _limbs(rng, shape, field=F_STARK):
    if field.num_bits <= 16:
        limbs = np.zeros(shape + (field.n16,), dtype=np.uint32)
        limbs[..., 0] = rng.integers(0, field.p, size=shape)
        return limbs
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs


def _jax_plain_level(jfield, x, size, tw):
    """The JAX level with every Pallas form off: x (B, C, S, L), tw None,
    (L,) or (C, S, L)."""
    old = (jmm._FORCE_V2, jmm._FORCE_FUSED, jmm._FORCE_PALLAS)
    try:
        jmm._FORCE_V2, jmm._FORCE_FUSED, jmm._FORCE_PALLAS = False, False, False
        return np.asarray(jmm._dft_matmul(ops_for(jfield), jnp.asarray(x), size, False,
                                          tw=None if tw is None else jnp.asarray(tw)))
    finally:
        jmm._FORCE_V2, jmm._FORCE_FUSED, jmm._FORCE_PALLAS = old


@pytest.mark.parametrize("tw_case", ["none", "scalar", "table"])
@pytest.mark.parametrize("size", [32, 64, 128])
def test_level_planes_plain_matches_limb_level_and_jax(size, tw_case):
    bsz, ccols = 2, 3
    rng = np.random.default_rng(size)
    ops = LimbOps(F_STARK, "cpu")
    x = _limbs(rng, (bsz, size, ccols))
    # the extremes of a byte: all-ones limbs below p's top bit, and zero
    x[0, 0, 0] = 0xFFFF
    x[0, 0, 0, -1] = (1 << (F_STARK.num_bits - 1 - 16 * 15)) - 1
    x[1, :, 1] = 0
    tw = {"none": None, "scalar": _limbs(rng, ()), "table": _limbs(rng, (size, ccols))}[tw_case]
    xt = from_numpy_limbs(x, "cpu")
    twt = None if tw is None else from_numpy_limbs(tw, "cpu")
    w = tmm.dft_matrix(ops, size, False)
    got = K.ntt_level_planes_plain(F_STARK, xt, tmm.dft_matrix_planes(ops, size, False), twt)
    assert got.dtype == torch.int32
    assert torch.equal(got, K.ntt_level_plain(F_STARK, xt, w, twt))
    jtw = tw if tw is None or tw.ndim == 1 else np.ascontiguousarray(tw.transpose(1, 0, 2))
    ref = _jax_plain_level(JF_STARK, np.ascontiguousarray(x.transpose(0, 2, 1, 3)), size, jtw)
    assert np.array_equal(to_numpy_limbs(got).transpose(0, 2, 1, 3), ref)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matrix_planes_are_the_bytes_of_dft_matrix(name, inverse):
    field, jfield = FIELDS[name]
    ops = LimbOps(field, "cpu")
    size = 32
    planes = tmm.dft_matrix_planes(ops, size, inverse)
    w = tmm.dft_matrix(ops, size, inverse)
    assert planes.dtype == torch.uint8 and tuple(planes.shape) == (2 * field.n16, size, size)
    assert planes.is_contiguous()
    assert torch.equal(planes[0::2].permute(1, 2, 0).to(torch.int32), w & 0xFF)
    assert torch.equal(planes[1::2].permute(1, 2, 0).to(torch.int32), w >> 8)
    jbytes = jmm._dft_matrix_bytes(jfield, size, inverse)  # (S, S, P) float bytes
    assert np.array_equal(planes.permute(1, 2, 0).numpy(), np.asarray(jbytes).astype(np.uint8))


def test_ntt_level_body_follows_field_and_radix():
    assert [K.ntt_level_body(F_STARK, s) for s in (128, 64, 32, 16, 8, 4, 2, 1)] == \
        ["mma", "mma", "mma", "limb", "butterfly", "butterfly", "butterfly", "limb"]
    assert [K.ntt_level_body(F257, s) for s in (128, 32, 16, 8, 4, 2)] == \
        ["limb"] * 3 + ["butterfly"] * 3
    assert [K.ntt_level_body(f, s) for f in (F_BLS, F_P63) for s in (4, 2)] == ["butterfly"] * 4
    with pytest.raises(ValueError):
        K.ntt_level_body(F_STARK, 256)


def _pow_inputs(field):
    """Random canonical elements with 0, 1 and p - 1 among them, in
    Montgomery form, as numpy u32 limbs."""
    rng = np.random.default_rng(field.n16)
    vals = [0, 1, field.p - 1] + [int(rng.integers(2, 1 << 62)) % field.p for _ in range(4)]
    return pack_ints([field.to_mont(v) for v in vals], field.n16), vals


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_pow_matches_jax_pow_static(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    limbs, vals = _pow_inputs(field)
    x = from_numpy_limbs(limbs, "cpu")
    for e in (0, 1, 2, 3, 5, 16, 255, field.p - 2):
        got = to_numpy_limbs(ops.pow_static(x, e))
        if e <= 255:
            ref = np.asarray(jops.pow_static(jnp.asarray(limbs), e))
            assert np.array_equal(got, ref), e
        assert list(ops.decode(got)) == [pow(v, e, field.p) for v in vals], e
        assert np.array_equal(to_numpy_limbs(K.mont_pow(field, x, e)), got), e


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_inv_fermat_matches_jax(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    limbs, vals = _pow_inputs(field)
    limbs, vals = limbs[1:], vals[1:]  # zero has no inverse
    x = from_numpy_limbs(limbs, "cpu")
    got = ops.inv_fermat(x)
    assert np.array_equal(to_numpy_limbs(got), np.asarray(jops.inv_fermat(jnp.asarray(limbs))))
    one = ops.one_m.expand(x.shape)
    assert torch.equal(ops.mul(x, got), one)
    assert torch.equal(ops.inv_fermat(x[0]), got[0])  # a single (n16,) element
    assert torch.equal(got[0], ops.one_m) and torch.equal(got[1], x[1])  # 1 and p - 1


def test_mont_pow_rejects_bad_exponents():
    ops = LimbOps(F_STARK, "cpu")
    with pytest.raises(ValueError):
        K.mont_pow(F_STARK, ops.one_m, -1)
    with pytest.raises(ValueError):
        K.mont_pow(F_STARK, ops.one_m, 1 << 256)


@pytest.mark.parametrize("case", ["unaligned_base", "unaligned_stride"])
def test_elementwise_wrappers_refuse_unaligned_elements(case):
    """The kernels read an element through 16-byte loads; the geometry the
    wrappers hand them refuses anything else (checked on the layout alone,
    which a CPU tensor has too)."""
    buf = torch.zeros(6 * 4 + 2, dtype=torch.int32)
    if case == "unaligned_base":
        a = buf[2:].reshape(6, 4)
    else:
        a = torch.as_strided(buf, (4, 4), (6, 1))
    b = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        K._launch_geometry(a, b, a.shape)
