"""The operand copies over which hodor_tpu_torch/tools/launch_cost.py's
`device_time_ms` cycles its timed calls, so that no call finds its
operands in L2 from the calls before it: on the CPU, each copy of a call
computes what the call computes, from storages of its own, with every
view's shape, strides and offset kept. The timing itself needs the card
(chip_smoke.py phase 3)."""

import pytest
import torch

from hodor_tpu_torch.field import F_P63, F_STARK, LimbOps
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.fri.fri import fold_twiddles
from hodor_tpu_torch.tools.launch_cost import input_copies

torch.set_num_threads(1)

VIEWS = {
    "contiguous": lambda t: t,
    "offset": lambda t: t[3:],
    "row-strided": lambda t: t[1::2],
    "transposed": lambda t: t.reshape(4, 25, 4).transpose(0, 1),
    "broadcast row": lambda t: t[:1].expand(100, 4),
    "one element": lambda t: t[7],
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_copies_keep_the_view(view):
    base = torch.arange(400, dtype=torch.int32).reshape(100, 4)
    x = VIEWS[view](base)
    other = torch.arange(8, dtype=torch.int32)
    fns = input_copies(lambda: (x, other), sweep_bytes=4 * 1632)
    assert len(fns) == 4 and fns[0]() == (x, other)
    storages = {base.untyped_storage().data_ptr(), other.untyped_storage().data_ptr()}
    for fn in fns[1:]:
        got, got_other = fn()
        assert torch.equal(got, x) and torch.equal(got_other, other)
        assert got.shape == x.shape and got.stride() == x.stride()
        assert got.storage_offset() == x.storage_offset()
        for t in (got, got_other):
            assert t.untyped_storage().data_ptr() not in storages
            storages.add(t.untyped_storage().data_ptr())


def test_views_of_one_storage_share_one_copy():
    """The two halves of a fold's values are one storage: copied once,
    counted once."""
    base = torch.arange(400, dtype=torch.int32).reshape(100, 4)
    lo, hi = base[:50], base[50:]
    fns = input_copies(lambda: (lo, hi), sweep_bytes=3 * 1600)
    assert len(fns) == 3
    for fn in fns[1:]:
        got_lo, got_hi = fn()
        assert got_lo.untyped_storage().data_ptr() == got_hi.untyped_storage().data_ptr()
        assert got_lo.untyped_storage().data_ptr() != base.untyped_storage().data_ptr()
        assert torch.equal(got_lo, lo) and torch.equal(got_hi, hi)
        assert got_hi.storage_offset() == hi.storage_offset()


@pytest.mark.parametrize("sweep,cap,want", [(1, 64, 1), (1600, 64, 1), (1601, 64, 2),
                                            (16000, 64, 10), (16000, 4, 4)])
def test_copy_count(sweep, cap, want):
    """The least number of copies whose storages hold the sweep, at most
    the cap; the call itself is the first."""
    base = torch.zeros(400, dtype=torch.int32)

    def fn():
        return base

    fns = input_copies(fn, sweep_bytes=sweep, max_copies=cap)
    assert len(fns) == want and fns[0] is fn


def test_a_call_without_tensors_is_not_copied():
    field = F_STARK

    def fn():
        return field.n16

    assert input_copies(fn) == [fn]


def test_defaults_are_copied():
    base = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    fns = input_copies(lambda x=base[2:], n=3: (x, n), sweep_bytes=320)
    assert len(fns) == 2
    got, n = fns[1]()
    assert n == 3 and torch.equal(got, base[2:]) and got.storage_offset() == 8
    assert got.untyped_storage().data_ptr() != base.untyped_storage().data_ptr()


@pytest.mark.parametrize("kernel", ["mont_mul", "addsub", "fri_fold"])
def test_copies_of_a_wrapper_call_compute_the_same(kernel):
    """The elementwise wrappers' calls as launch_cost.py times them: every
    copy gives the call's limbs."""
    field = F_P63
    ops = LimbOps(field, "cpu")
    a = ops.encode(list(range(1, 65)))
    b = ops.encode(list(range(100, 164)))
    calls = {
        "mont_mul": lambda: K.mont_mul(field, a, b),
        "addsub": lambda: K.addsub(field, a[1:], b[:-1], "sub"),
        "fri_fold": lambda: K.fri_fold(field, a[:32], a[32:], b.view(-1)[:8],
                                       fold_twiddles(ops, 6), 2, 3),
    }
    fns = input_copies(calls[kernel], sweep_bytes=4 * a.untyped_storage().nbytes())
    assert len(fns) >= 2
    want = fns[0]()
    for fn in fns[1:]:
        assert torch.equal(fn(), want)
