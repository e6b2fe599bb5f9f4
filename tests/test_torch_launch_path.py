"""The elementwise launch path of the port's kernel wrappers
(hodor_tpu_torch/field/kernels.py), on the CPU: the launch arguments
that `mont_mul` and `addsub` cache by operand layout against
`_launch_geometry`, their plain reference; the body both launchers pick;
the fold's cached strides; and the errors a bad operand raises, on a
layout's first call and on a cached one. The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""

import ctypes

import numpy as np
import pytest
import torch

from hodor_tpu_torch.field import F257, F_P63, F_STARK, LimbOps
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.fri.fri import fold_twiddles

torch.set_num_threads(1)


def _rnd(g, *shape, n16=4):
    return torch.randint(0, 1 << 15, shape + (n16,), generator=g, dtype=torch.int32)


def _layouts(n16):
    """(a, b) of the layouts of test_torch_kernels.py's
    test_launch_geometry_reads_the_broadcast, the scalar and row-strided
    forms the prove issues, and edge sizes."""
    g = torch.Generator().manual_seed(11)
    flat = _rnd(g, 700, n16=n16)
    return {
        "same": (_rnd(g, 6, 5, n16=n16), _rnd(g, 6, 5, n16=n16)),
        "scalar": (_rnd(g, 6, 5, n16=n16), _rnd(g, n16=n16)),
        "scalar first": (_rnd(g, n16=n16), _rnd(g, 1001, n16=n16)),
        "period": (_rnd(g, 3, 6, 5, n16=n16), _rnd(g, 6, 5, n16=n16)),
        "period, wide inner": (_rnd(g, 16, 40, n16=n16), _rnd(g, 40, n16=n16)),
        "lde": (_rnd(g, 2, 7, n16=n16)[:, None], _rnd(g, 4, 7, n16=n16)),
        "lde, wide inner": (_rnd(g, 2, 70, n16=n16)[:, None], _rnd(g, 5, 70, n16=n16)),
        "strided": (_rnd(g, 12, 5, n16=n16)[::2], _rnd(g, 5, n16=n16)[None].expand(6, 5, n16)),
        "row-strided halves": (flat[0::2], flat[1::2]),
        "offset view": (flat[1:], flat[:-1]),
        "transposed": (_rnd(g, 5, 6, n16=n16).transpose(0, 1), _rnd(g, 2, 6, 5, n16=n16)[1]),
        "four dims": (_rnd(g, 2, 3, 4, 5, n16=n16).permute(3, 1, 0, 2, 4),
                      _rnd(g, 5, 3, 2, 4, n16=n16)),
        "one element": (flat[:1], flat[1:2]),
        "three elements": (flat[:3], flat[5:8]),
    }


LAYOUTS = sorted(_layouts(4))


def _as_list(arr):
    return list(arr) if arr is not None else None


def _field(n16):
    return F_P63 if n16 == 4 else F_STARK


@pytest.mark.parametrize("n16", [4, 16])
@pytest.mark.parametrize("case", LAYOUTS)
def test_cached_launch_equals_the_geometry(case, n16):
    """The cached path gives the dims, strides and body of
    `_launch_geometry` on a layout's first call and on every later one,
    and the later calls find the first call's entry."""
    a, b = _layouts(n16)[case]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2, b2, dims, a_st, b_st = K._launch_geometry(a, b, shape)
    K._elementwise_launches.clear()
    first, fa, fb = K._elementwise_launch(_field(n16), a, b)
    again, ga, gb = K._elementwise_launch(_field(n16), a, b)
    assert again is first
    assert first.shape == shape
    assert first.copy == (a2 is not a)
    assert _as_list(first.dims) == dims
    assert _as_list(first.a_strides) == a_st and _as_list(first.b_strides) == b_st
    assert first.body == K._elementwise_body(dims) == K.mont_mul_body(a, b)
    for x, want in ((fa, a2), (fb, b2), (ga, a2), (gb, b2)):
        assert x.shape == want.shape and x.stride() == want.stride()
        assert torch.equal(x, want)


@pytest.mark.parametrize("case", LAYOUTS)
def test_addsub_body_is_mont_mul_body(case):
    a, b = _layouts(4)[case]
    assert K.addsub_body(a, b) == K.mont_mul_body(a, b)


def test_every_body_is_picked():
    """Each of the three bodies serves some layout of the prove's kinds."""
    picked = {case: K.addsub_body(*ab) for case, ab in _layouts(4).items()}
    assert picked["same"] == picked["scalar"] == picked["offset view"] == "flat"
    assert picked["row-strided halves"] == picked["one element"] == "flat"
    assert picked["period, wide inner"] == picked["lde, wide inner"] == "grid"
    assert picked["transposed"] == picked["lde"] == "general"
    assert set(picked.values()) == set(K.ADDSUB_BODIES)


def test_body_rule_at_its_edges():
    assert K._elementwise_body([1, 1, 5]) == "flat"
    assert K._elementwise_body([1, 2, 32]) == "grid"
    assert K._elementwise_body([65535, 65535, 32]) == "grid"
    assert K._elementwise_body([1, 2, 31]) == "general"
    assert K._elementwise_body([65536, 2, 32]) == "general"
    assert K._elementwise_body([1, 65536, 32]) == "general"


def test_cached_launch_reads_the_broadcast():
    """The cached arguments index a second pair of operands of the same
    layout (other storage) as the broadcast of that pair."""
    g = torch.Generator().manual_seed(12)
    for make in (lambda: (_rnd(g, 2, 40)[:, None], _rnd(g, 3, 40)),
                 lambda: (_rnd(g, 5, 6).transpose(0, 1), _rnd(g, 6, 5))):
        K._elementwise_launch(F_P63, *make())
        a, b = make()
        launch, a2, b2 = K._elementwise_launch(F_P63, a, b)
        n = int(np.prod(launch.shape[:-1]))
        for t, t2, st in ((a, a2, launch.a_strides), (b, b2, launch.b_strides)):
            flat = torch.as_strided(t2, (t2.untyped_storage().nbytes() // 4,), (1,), 0)
            got = [flat[t2.storage_offset() + i0 * st[0] + i1 * st[1] + i2 * st[2]:][:4]
                   for i0 in range(launch.dims[0]) for i1 in range(launch.dims[1])
                   for i2 in range(launch.dims[2])]
            assert torch.equal(torch.stack(got), t.expand(launch.shape).reshape(n, 4))


def test_cached_launch_checks_every_base():
    """A layout seen before with an aligned base still refuses an
    unaligned one: the base is checked on every call."""
    buf = torch.zeros(8 * 4 + 2, dtype=torch.int32)
    aligned, unaligned = buf[:32].reshape(8, 4), buf[2:34].reshape(8, 4)
    assert aligned.stride() == unaligned.stride()
    b = torch.zeros(8, 4, dtype=torch.int32)
    K._elementwise_launch(F_P63, aligned, b)
    with pytest.raises(ValueError):
        K._launch_geometry(unaligned, b, b.shape)
    with pytest.raises(ValueError):
        K._elementwise_launch(F_P63, unaligned, b)
    K._elementwise_launches.clear()
    with pytest.raises(ValueError):
        K._elementwise_launch(F_P63, unaligned, b)


@pytest.mark.parametrize("case", ["unaligned_stride", "limb_stride", "mismatch"])
def test_cached_launch_refuses_what_the_geometry_refuses(case):
    buf = torch.zeros(6 * 4 + 2, dtype=torch.int32)
    if case == "unaligned_stride":
        a, b, err = torch.as_strided(buf, (4, 4), (6, 1)), torch.zeros(4, dtype=torch.int32), \
            ValueError
    elif case == "limb_stride":
        a, b, err = torch.zeros(4, 8, dtype=torch.int32)[:, ::2], \
            torch.zeros(4, dtype=torch.int32), ValueError
    else:
        a, b, err = torch.zeros(3, 4, dtype=torch.int32), torch.zeros(5, 4, dtype=torch.int32), \
            RuntimeError
    K._elementwise_launches.clear()
    for _ in range(2):  # nothing is cached for a refused layout
        with pytest.raises(err):
            K._elementwise_launch(F_P63, a, b)
    assert not K._elementwise_launches


@pytest.mark.parametrize("bad", ["dtype", "n16", "device"])
def test_cached_layout_checks_dtype_width_and_device(bad):
    """The cache key holds each operand's dtype and device and the field's
    width: an operand of a cached layout's shape and strides with another
    dtype, under a field of another width, or on another device, is
    checked as on a first call and refused."""
    a = torch.zeros(8, 4, dtype=torch.int32)
    K._elementwise_launch(F_P63, a, a)
    if bad == "dtype":
        with pytest.raises(TypeError):
            K._elementwise_launch(F_P63, a.to(torch.int64), a)
    elif bad == "n16":
        with pytest.raises(ValueError):
            K._elementwise_launch(F_STARK, a, a)
    else:
        with pytest.raises(ValueError):
            K._elementwise_launch(F_P63, a, a.to("meta"))


def test_empty_output_is_not_cached():
    a = torch.zeros(0, 4, dtype=torch.int32)
    launch, _, _ = K._elementwise_launch(F_P63, a, torch.zeros(4, dtype=torch.int32))
    assert launch.shape == (0, 4) and launch.dims is None


def test_launch_arrays_are_ctypes():
    a = torch.zeros(5, 4, dtype=torch.int32)
    launch, _, _ = K._elementwise_launch(F_P63, a, a)
    for arr in (launch.dims, launch.a_strides, launch.b_strides):
        assert isinstance(arr, ctypes.Array) and len(arr) == 3


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("field", [F_STARK, F_P63, F257], ids=lambda f: f.name)
def test_fold_strides(field, lanes):
    """The fold's cached integer arguments: out's lane stride, the row and
    lane strides of lo and hi (the two halves, or interleaved rows), the
    roots' lane stride, half and the lane count."""
    n = field.n16
    half = 7
    values = torch.zeros((2 * half, n) if lanes is None else (lanes, 2 * half, n),
                         dtype=torch.int32)
    roots = torch.zeros((8,) if lanes is None else (lanes, 8), dtype=torch.int32)
    lane_stride = 0 if lanes is None else 2 * half * n
    for lo, hi, row in ((values[..., :half, :], values[..., half:, :], n),
                        (values[..., 0::2, :], values[..., 1::2, :], 2 * n)):
        assert K._fold_strides(field, lo, hi, roots) == (
            half * n, row, lane_stride, row, lane_stride, 0 if lanes is None else 8, half,
            1 if lanes is None else lanes)


def test_fold_refuses_unaligned_rows():
    buf = torch.zeros(64 * 4 + 2, dtype=torch.int32)
    rows = torch.as_strided(buf, (4, 16), (18, 1))
    with pytest.raises(ValueError):
        K._fold_strides(F_STARK, rows, rows, torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("first", [True, False])
def test_wrappers_raise_the_same_errors_after_a_cached_layout(first):
    """A bad operand raises the same exception on a layout's first call and
    once its layout (or a good operand's of the same shape) is cached."""
    ops = LimbOps(F_STARK, "cpu")
    v = ops.encode(list(range(8)))
    root, tw = torch.zeros(8, dtype=torch.int32), fold_twiddles(ops, 4)
    if not first:
        K.fri_fold(F_STARK, v[:4], v[4:], root, tw, 1)
        K.addsub(F_STARK, v, v, "add")
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:7], root, tw, 1)
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:], root[:1], tw, 1)
    with pytest.raises(ValueError):
        K.fri_fold(F_STARK, v[:4], v[4:], root, tw, 3)
    with pytest.raises(TypeError):
        K.fri_fold(F_STARK, v[:4].to(torch.int64), v[4:], root, tw, 1)
    with pytest.raises(TypeError):
        K.addsub(F_STARK, v.to(torch.int64), v, "add")
    with pytest.raises(ValueError):
        K.addsub(F_STARK, v, v, "mul")
    with pytest.raises(ValueError):
        K.addsub(F_STARK, v[:, :4], v[:, :4], "add")
    with pytest.raises(ValueError):
        K.mont_mul(F_STARK, v.to("meta"), v.to("meta"))
