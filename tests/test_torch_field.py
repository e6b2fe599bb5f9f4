"""The port's LimbOps (hodor_tpu_torch.field) against hodor_tpu's LimbOps
and Python ints, on CPU tensors (the kernels' plain versions).

Inputs are made from a seed and cross between the packages as numpy
limb arrays; every output is canonical, so equality is exact."""

import random

import jax
import numpy as np
import pytest
import torch

from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK, ops_for
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels

torch.set_num_threads(1)

FIELDS = {"F_STARK": (F_STARK, JF_STARK), "F257": (F257, JF257)}


def _values(field, n, seed):
    rng = random.Random(seed)
    edge = [0, 1, field.p - 1, field.p - 2]
    return edge + [rng.randrange(field.p) for _ in range(n - len(edge))]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_encode_decode_match_jax(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    xs = _values(field, 64, 1)
    mine = ops.encode(xs)
    assert mine.dtype == torch.int32 and tuple(mine.shape) == (64, field.n16)
    assert (to_numpy_limbs(mine) == np.asarray(jops.encode(xs))).all()
    assert list(ops.decode(mine)) == xs
    back = from_numpy_limbs(np.asarray(jops.encode(xs)), "cpu")
    assert torch.equal(back, mine)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_binary_ops_match_jax_and_ints(name, op):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    xs = _values(field, 64, 2)
    ys = list(reversed(_values(field, 64, 3)))
    ja, jb = jops.encode(xs), jops.encode(ys)
    a, b = from_numpy_limbs(np.asarray(ja), "cpu"), from_numpy_limbs(np.asarray(jb), "cpu")
    mine = getattr(ops, op)(a, b)
    ref = np.asarray({"add": jops.jadd, "sub": jops.jsub, "mul": jops.jmul}[op](ja, jb))
    assert (to_numpy_limbs(mine) == ref).all()
    p = field.p
    want = {"add": lambda x, y: (x + y) % p, "sub": lambda x, y: (x - y) % p,
            "mul": lambda x, y: x * y % p}[op]
    assert list(ops.decode(mine)) == [want(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_broadcast_scalar_and_neg(name):
    field, _ = FIELDS[name]
    ops = LimbOps(field, "cpu")
    xs = _values(field, 32, 4)
    a = ops.encode(xs)
    c = ops.const(12345 % field.p)
    assert list(ops.decode(ops.mul(a, c))) == [x * (12345 % field.p) % field.p for x in xs]
    assert list(ops.decode(ops.sub(c, a))) == [(12345 - x) % field.p for x in xs]
    assert list(ops.decode(ops.neg(a))) == [(-x) % field.p for x in xs]
    rinv = pow(field.R, -1, field.p)
    assert list(ops.decode(ops.from_mont_arr(a))) == [x * rinv % field.p for x in xs]
    assert [int(x) for x in ops.decode(ops.to_mont_arr(ops.from_mont_arr(a)))] == xs


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_powers_match_jax(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    g, s = 7 % field.p, 3
    mine = ops.powers(ops.const(g), 37, start=ops.const(s))
    ref = jax.jit(lambda x, st: jops.powers(x, 37, start=st))(jops.const(g), jops.const(s))
    assert (to_numpy_limbs(mine) == np.asarray(ref)).all()
    assert list(ops.decode(mine)) == [s * pow(g, i, field.p) % field.p for i in range(37)]
    batch = ops.powers(ops.encode([2, 5]), 9)
    assert [list(r) for r in ops.decode(batch)] == [
        [pow(b, i, field.p) for i in range(9)] for b in (2, 5)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_inverses_match_jax_and_ints(name):
    field, jfield = FIELDS[name]
    ops, jops = LimbOps(field, "cpu"), ops_for(jfield)
    xs = [x for x in _values(field, 24, 5) if x]
    a = ops.encode(xs)
    want = [pow(x, -1, field.p) for x in xs]
    assert list(ops.decode(ops.batch_inverse(a))) == want
    assert list(ops.decode(ops.inv_fermat(a))) == want
    ref = jax.jit(jops.batch_inverse)(jops.encode(xs))
    assert (to_numpy_limbs(ops.batch_inverse(a)) == np.asarray(ref)).all()


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_reductions_and_pow(name):
    field, _ = FIELDS[name]
    ops = LimbOps(field, "cpu")
    xs = _values(field, 13, 6)
    a = ops.encode(xs)
    assert ops.decode(ops.sum_reduce(a)) == sum(xs) % field.p
    prefix = []
    acc = 1
    for x in xs:
        acc = acc * x % field.p
        prefix.append(acc)
    assert list(ops.decode(ops.prod_scan(a))) == prefix
    assert list(ops.decode(ops.pow_static(a, 5))) == [pow(x, 5, field.p) for x in xs]
    assert list(ops.decode(ops.pow_static(a, 0))) == [1] * len(xs)
    assert ops.is_zero(ops.encode([0, 1])).tolist() == [True, False]
    picked = ops.select(torch.tensor([True, False] * 6 + [True]), a, ops.neg(a))
    assert list(ops.decode(picked)) == [x if i % 2 == 0 else (-x) % field.p
                                        for i, x in enumerate(xs)]


def test_u32_narrowing_cast():
    vals = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF, 0xDEADBEEF], dtype=torch.int64)
    narrowed = kernels.u32_to_i32(vals)
    assert narrowed.dtype == torch.int32
    assert (narrowed.numpy().view(np.uint32) == vals.numpy().astype(np.uint32)).all()


def test_limbs_reject_wrong_layout():
    ops = LimbOps(F_STARK, "cpu")
    a = ops.encode([1, 2])
    with pytest.raises(TypeError):
        ops.mul(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        ops.mul(a[:, :8], a[:, :8])
    with pytest.raises(ValueError):
        from_numpy_limbs(np.array([[1 << 16]], dtype=np.uint32), "cpu")
