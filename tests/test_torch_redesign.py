"""The plain versions behind the kernels redesigned for the H100 (the
mont_pow entry of mont_mul) on CPU tensors, against the JAX package's
LimbOps.inv_fermat / pow_static on the same limbs; the bytes of the
port's DFT matrix against the JAX package's; which body of ntt_level a
level takes; the elementwise wrappers' refusal of unaligned elements.
Inputs from numpy seeds; tolerance 0 (canonical outputs)."""

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


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matrix_bytes_match_jax(name, inverse):
    """The bytes of the port's DFT matrix are the JAX package's byte form
    of its own (the matrix the "two_step" and "fused" forms fold)."""
    field, jfield = FIELDS[name]
    ops = LimbOps(field, "cpu")
    size = 32
    w = tmm.dft_matrix(ops, size, inverse)
    got = torch.stack([w & 0xFF, w >> 8], dim=-1).reshape(size, size, 2 * field.n16)
    jbytes = jmm._dft_matrix_bytes(jfield, size, inverse)  # (S, S, P) float bytes
    assert np.array_equal(got.numpy(), np.asarray(jbytes).astype(np.int32))


def test_ntt_level_body_follows_field_and_radix():
    assert [K.ntt_level_body(F_STARK, s) for s in (128, 64, 32, 16, 8, 4, 2, 1)] == \
        ["limb", "limb", "limb", "limb", "butterfly", "butterfly", "butterfly", "limb"]
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
