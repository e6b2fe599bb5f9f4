"""The port's FRI fold (hodor_tpu_torch.fri.fri.fold_round, which on CPU
tensors runs the fri_fold kernel's plain version) against the JAX
package's fold with its Pallas fold kernel in interpret mode and with the
kernel off, on the same numpy-seeded inputs. Tolerance 0: every output is
canonical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hodor_tpu.fri.fri as jfri
from hodor_tpu.field import F_STARK as JF_STARK, ops_for
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.fri.fri import fold_round

torch.set_num_threads(1)

LOG_DOMAIN = 13


def _limbs(rng, shape):
    """Uniform canonical F_STARK limbs (the top limb cut below p's top bit)."""
    limbs = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.uint32)
    limbs[..., -1] &= 0x7FF
    return limbs


@pytest.mark.parametrize("jax_kernel", ["interpret", False], ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("round_index", [0, 1])
def test_fold_round_matches_jax(round_index, jax_kernel):
    """Round i folds a 2^(13-i)-element vector with stride 2^i; round 0 is
    large enough for the Pallas kernel's tiles."""
    rng = np.random.default_rng(47)
    values = _limbs(rng, (1 << (LOG_DOMAIN - round_index),))
    challenge = _limbs(rng, ())
    stride = 1 << round_index
    old = jfri._FORCE_PALLAS
    try:
        jfri._FORCE_PALLAS = jax_kernel
        want = np.asarray(jfri._fold_round_body(
            ops_for(JF_STARK), jnp.asarray(values), jnp.asarray(challenge), stride, LOG_DOMAIN))
    finally:
        jfri._FORCE_PALLAS = old
    ops = LimbOps(F_STARK, "cpu")
    got = fold_round(ops, from_numpy_limbs(values, "cpu"), from_numpy_limbs(challenge, "cpu"),
                     stride, LOG_DOMAIN)
    assert got.dtype == torch.int32
    assert np.array_equal(to_numpy_limbs(got), want)


@pytest.mark.parametrize("field", [F_STARK, F257], ids=lambda f: f.name)
@pytest.mark.parametrize("half", [1, 3, 64])
def test_fri_fold_equals_the_elementwise_fold(field, half):
    """The fused association equals (lo + hi + c w (lo - hi)) / 2 on the
    separate add, sub and mul, also on row-strided views and edge sizes."""
    rng = np.random.default_rng(half)
    ops = LimbOps(field, "cpu")
    ints = [int(v) % field.p for v in rng.integers(0, 1 << 62, size=4 * half + 1)]
    enc = ops.encode(ints)
    values, w, c = enc[:2 * half], enc[2 * half:4 * half:2], enc[-1]
    for lo, hi in ((values[:half], values[half:]), (values[0::2], values[1::2])):
        odd = ops.mul(ops.sub(lo, hi), w)
        want = ops.mul(ops.add(ops.add(lo, hi), ops.mul(odd, c)), ops.two_inv_m)
        got = K.fri_fold(field, lo, hi, w, ops.mul(c, ops.two_inv_m), ops.two_inv_m)
        assert torch.equal(got, want)
        out = torch.empty_like(got)
        assert K.fri_fold(field, lo, hi, w, ops.mul(c, ops.two_inv_m), ops.two_inv_m,
                          out=out) is out
        assert torch.equal(out, want)


def test_fri_fold_rejects_bad_operands():
    ops = LimbOps(F_STARK, "cpu")
    v = ops.encode(list(range(8)))
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:], v[:3], ops.two_inv_m, ops.two_inv_m)
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:], v[:4], v[:1], ops.two_inv_m)
    with pytest.raises(TypeError):
        K.fri_fold(F_STARK, v[:4].to(torch.int64), v[4:], v[:4], ops.two_inv_m, ops.two_inv_m)
