"""The plain versions of the port's first four kernels (hodor_tpu_torch.
field.kernels, what a CPU tensor runs; the other three are held in
test_torch_fold.py and test_torch_ntt_impls.py) against the JAX package's Pallas kernels
in interpret mode, as tests/test_pallas.py runs them (the NTT level also
against the JAX package's plain level), and the launch geometry the CUDA
wrappers hand their kernels.

Inputs are made from a seed; equality is exact (canonical outputs)."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hodor_tpu.field import F257 as JF257, F_STARK as JF_STARK, ops_for
from hodor_tpu.field.pallas_kernels import pallas_addsub, pallas_blake2s, pallas_mont_mul_v2
from hodor_tpu.merkle.blake2s import keyed_midstate as jax_midstate
from hodor_tpu_torch.field import F257, F_STARK, LimbOps, from_numpy_limbs, to_numpy_limbs
from hodor_tpu_torch.field import kernels
from hodor_tpu_torch.merkle.blake2s import KEY, PERSONAL, keyed_midstate
from hodor_tpu_torch.ntt.matmul import dft_matrix

torch.set_num_threads(1)

FIELDS = {"F_STARK": (F_STARK, JF_STARK), "F257": (F257, JF257)}


def _limbs(field, shape, seed):
    """Seeded canonical limbs, numpy u32: uniform below p for a small p,
    else uniform limbs with the top limb cut below p's top bit."""
    rng = np.random.default_rng(seed)
    if field.num_bits < 63:
        vals = rng.integers(0, field.p, size=shape, dtype=np.int64)
        return np.stack([(vals >> (16 * i)) & 0xFFFF for i in range(field.n16)],
                        axis=-1).astype(np.uint32)
    limbs = rng.integers(0, 1 << 16, size=shape + (field.n16,), dtype=np.uint32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_mul_plain_matches_pallas_v2(name):
    field, jfield = FIELDS[name]
    a, b = _limbs(field, (4096,), 1), _limbs(field, (4096,), 2)
    ref = np.asarray(pallas_mont_mul_v2(jfield, jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = kernels.mont_mul(field, from_numpy_limbs(a, "cpu"), from_numpy_limbs(b, "cpu"))
    assert (to_numpy_limbs(got) == ref).all()


@pytest.mark.parametrize("mode", ["add", "sub"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_addsub_plain_matches_pallas(name, mode):
    field, jfield = FIELDS[name]
    a, b = _limbs(field, (4096,), 3), _limbs(field, (4096,), 4)
    ref = np.asarray(pallas_addsub(jfield, jnp.asarray(a), jnp.asarray(b), mode, interpret=True))
    got = kernels.addsub(field, from_numpy_limbs(a, "cpu"), from_numpy_limbs(b, "cpu"), mode)
    assert (to_numpy_limbs(got) == ref).all()


@pytest.mark.parametrize("message_bytes", [32, 64])
def test_blake2s_plain_matches_pallas_and_hashlib(message_bytes):
    assert keyed_midstate() == tuple(int(v) for v in jax_midstate())
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(4096, message_bytes // 4), dtype=np.uint64)
    words = words.astype(np.uint32)
    padded = np.zeros((4096, 16), dtype=np.uint32)
    padded[:, : message_bytes // 4] = words
    ref = np.asarray(pallas_blake2s(jnp.asarray(padded), message_bytes,
                                    keyed_midstate(), interpret=True))
    got = kernels.blake2s(torch.from_numpy(words.view(np.int32)), message_bytes, keyed_midstate())
    assert got.dtype == torch.int32
    assert (got.numpy().view(np.uint32) == ref).all()
    for i in (0, 1, 4095):
        digest = hashlib.blake2s(words[i].astype("<u4").tobytes(), key=KEY,
                                 person=PERSONAL).digest()
        assert got[i].numpy().astype("<i4").tobytes() == digest


def _jax_level(jfield, x, size, tw, form):
    """The JAX level on x (B, C, S, L) or (C, S, L), transforming axis -2,
    tw None, (L,) or (C, S, L): its Pallas v2 kernel in interpret mode
    ("v2"), or its plain jnp form with every Pallas form off ("plain")."""
    from hodor_tpu.ntt import matmul as mm

    old = (mm._FORCE_V2, mm._FORCE_FUSED, mm._FORCE_PALLAS, mm._V2_IMPL)
    try:
        if form == "v2":
            mm._FORCE_V2, mm._V2_IMPL = "interpret", "bf16"
            jax.clear_caches()
        else:
            mm._FORCE_V2, mm._FORCE_FUSED, mm._FORCE_PALLAS = False, False, False
        kw = {"tw": jnp.asarray(tw)} if tw is not None else {}
        return np.asarray(mm._dft_matmul(ops_for(jfield), jnp.asarray(x), size, False, **kw))
    finally:
        mm._FORCE_V2, mm._FORCE_FUSED, mm._FORCE_PALLAS, mm._V2_IMPL = old
        if form == "v2":
            jax.clear_caches()


# (JAX form, field, S, twiddle): the Pallas v2 level at (1, 128, 128) with
# no twiddle or a table; the plain level at (2, S, 3), S = 32, 64, 128 (the
# radices a 16-limb level takes the limb body at on the card), with no, a
# scalar and a table twiddle, on inputs with a byte's extremes among them
LEVEL_CASES = [
    pytest.param("v2", name, 128, "table" if with_tw else "none", id=f"{name}-{with_tw}")
    for name in ("F_STARK", "F257") for with_tw in (False, True)
] + [
    pytest.param("plain", "F_STARK", size, tw_case, id=f"plain-{size}-{tw_case}")
    for size in (32, 64, 128) for tw_case in ("none", "scalar", "table")
]


@pytest.mark.parametrize("form, name, size, tw_case", LEVEL_CASES)
def test_ntt_level_plain_matches_pallas_v2(form, name, size, tw_case):
    """The port's level reads (B, S, C, L), transforming axis 1, and takes a
    table twiddle as (S, C, L) wrapping over B; the JAX level reads the same
    data as (B, C, S, L) with its table as (C, S, L)."""
    field, jfield = FIELDS[name]
    ops = LimbOps(field, "cpu")
    if form == "v2":
        bsz, ccols = 1, 128
        x = _limbs(field, (bsz, size, ccols), 6)
    else:
        bsz, ccols = 2, 3
        x = _limbs(field, (bsz, size, ccols), size)
        # the extremes of a byte: all-ones limbs below p's top bit, and zero
        x[0, 0, 0] = 0xFFFF
        x[0, 0, 0, -1] = (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
        x[1, :, 1] = 0
    tw = {"none": None, "scalar": _limbs(field, (), 7),
          "table": _limbs(field, (size, ccols), 7)}[tw_case]
    xt = from_numpy_limbs(x, "cpu")
    twt = None if tw is None else from_numpy_limbs(tw, "cpu")
    got = kernels.ntt_level(field, xt, dft_matrix(ops, size, False), twt)
    assert got.dtype == torch.int32
    jx = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    jtw = tw if tw is None or tw.ndim == 1 else np.ascontiguousarray(tw.transpose(1, 0, 2))
    ref = _jax_level(jfield, jx[0] if form == "v2" else jx, size, jtw, form)
    assert np.array_equal(to_numpy_limbs(got).transpose(0, 2, 1, 3), ref.reshape(jx.shape))


@pytest.mark.parametrize("size", [2, 8, 64])
def test_ntt_level_small_radix_is_the_dft(size):
    """A level with a scalar twiddle computes s * sum_j w^(kj) x[j] for
    every radix the transforms use (checked against Python ints)."""
    field = F_STARK
    ops = LimbOps(field, "cpu")
    x = _limbs(field, (3, size, 2), 8)
    s = 987654321
    got = kernels.ntt_level(field, from_numpy_limbs(x, "cpu"), dft_matrix(ops, size, False),
                            ops.const(s))
    from hodor_tpu_torch.domain import Domain

    w = Domain.new_for_size(field, size).generator
    xv = ops.decode(from_numpy_limbs(x, "cpu"))
    gv = ops.decode(got)
    for b in range(3):
        for c in range(2):
            for k in range(size):
                want = s * sum(int(xv[b, j, c]) * pow(w, k * j, field.p)
                               for j in range(size)) % field.p
                assert gv[b, k, c] == want


def _gather(t, dims, strides):
    """The CUDA elementwise kernels' operand indexing, in numpy: element i
    of the collapsed (d0, d1, d2) index space reads offset
    i0*s0 + i1*s1 + i2*s2 (int32 units) of the operand's storage."""
    base = t.storage_offset()
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // 4,), (1,), 0).numpy()
    n16 = t.shape[-1]
    out = []
    for i0 in range(dims[0]):
        for i1 in range(dims[1]):
            for i2 in range(dims[2]):
                off = base + i0 * strides[0] + i1 * strides[1] + i2 * strides[2]
                out.append(flat[off:off + n16])
    return np.stack(out)


@pytest.mark.parametrize("case", ["same", "scalar", "period", "lde", "strided", "transposed"])
def test_launch_geometry_reads_the_broadcast(case):
    ops = LimbOps(F257, "cpu")
    g = torch.Generator().manual_seed(9)

    def rnd(*shape):
        low = torch.randint(0, F257.p, shape + (1,), generator=g, dtype=torch.int32)
        return torch.cat([low, torch.zeros(shape + (3,), dtype=torch.int32)], dim=-1)

    a, b = {
        "same": (rnd(6, 5), rnd(6, 5)),
        "scalar": (rnd(6, 5), rnd()),
        "period": (rnd(3, 6, 5), rnd(6, 5)),
        "lde": (rnd(2, 7)[:, None], rnd(4, 7)),  # coeffs (R,1,T) x powers (F,T)
        "strided": (rnd(12, 5)[::2], rnd(5)[None].expand(6, 5, 4)),
        "transposed": (rnd(5, 6).transpose(0, 1), rnd(2, 6, 5)[1]),
    }[case]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2, b2, dims, a_st, b_st = kernels._launch_geometry(a, b, shape)
    assert len(dims) == 3
    n = int(np.prod(shape[:-1]))
    assert int(np.prod(dims)) == n
    for t, t2, st in ((a, a2, a_st), (b, b2, b_st)):
        want = t.expand(shape).reshape(n, 4).numpy()
        assert (_gather(t2, dims, st) == want).all()
    # the plain version agrees with elementwise ints on the same broadcast
    got = ops.mul(a, b)
    av = ops.decode(a.expand(shape))
    bv = ops.decode(b.expand(shape))
    want = np.vectorize(lambda x, y: x * y % F257.p, otypes=[object])(av, bv)
    assert (ops.decode(got) == want).all()


def test_reduction_chain_matches_jax():
    from hodor_tpu.ntt.matmul import _reduction_chain

    for field, jfield in FIELDS.values():
        for radix in (2, 8, 64, 128):
            want = [sum(int(l) << (16 * i) for i, l in enumerate(m))
                    for m in _reduction_chain(jfield, radix)]
            assert list(kernels.reduction_chain(field, radix)) == want


def test_wrappers_reject_bad_operands():
    field = F_STARK
    ops = LimbOps(field, "cpu")
    x = torch.zeros((1, 8, 1, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.ntt_level(field, x, dft_matrix(ops, 4, False))
    with pytest.raises(ValueError):
        kernels.blake2s(torch.zeros((4, 8), dtype=torch.int32), 64, keyed_midstate())
    with pytest.raises(ValueError):
        kernels.addsub(field, ops.one_m, ops.one_m, "mul")
    with pytest.raises(ValueError):
        kernels.mont_mul(field, ops.one_m.to("meta"), ops.one_m.to("meta"))
