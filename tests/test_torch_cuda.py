"""The port's CUDA kernels against their plain versions, and the whole
port against the golden vectors, on an NVIDIA GPU. Marked `cuda`: they
skip where torch sees no card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use and a GPU machine may not have.)

The shapes are small and ragged (no multiple of a block size), so every
kernel's edge masking runs. Equality is exact (canonical outputs)."""

import json
import os

import pytest
import torch

from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps
from hodor_tpu_torch.field import kernels as K
from hodor_tpu_torch.merkle.blake2s import keyed_midstate
from hodor_tpu_torch.ntt import intt, ntt
from hodor_tpu_torch.ntt import matmul as M
from hodor_tpu_torch.ntt.matmul import dft_matrix, encode_s8, folded_dft_matrix, max_radix

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
FIELDS = {"F_STARK": F_STARK, "F257": F257, "F_BLS": F_BLS, "F_P63": F_P63}


def _by_field(cases):
    """(name, *case) for every field and every case whose radix (its
    first entry) the field's level sums allow (ntt/matmul.py max_radix:
    4 for F_BLS and F_P63)."""
    return [(name, *case) for name in sorted(FIELDS) for case in cases
            if case[0] <= max_radix(FIELDS[name])]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    K.build_kernels()
    return torch.device("cuda", 0)


def _canonical(field, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if field.num_bits < 31:
        low = torch.randint(0, field.p, shape + (1,), generator=g, dtype=torch.int32)
        return torch.cat([low, torch.zeros(shape + (field.n16 - 1,), dtype=torch.int32)], -1)
    limbs = torch.randint(0, 1 << 16, shape + (field.n16,), generator=g, dtype=torch.int32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_mul_and_addsub_kernels(dev, name):
    field = FIELDS[name]
    a = _canonical(field, (3, 1001), 1)
    b = _canonical(field, (1001,), 2)
    s = _canonical(field, (), 3)
    for x, y in ((a, b), (a, s), (a[:, ::3], a[:, 1::3]), (a.transpose(0, 1), b[:, None])):
        xd, yd = x.to(dev), y.to(dev)
        _same(K.mont_mul(field, xd, yd), K.mont_mul_plain(field, x, y))
        for mode in ("add", "sub"):
            _same(K.addsub(field, xd, yd, mode), K.addsub_plain(field, x, y, mode))
    before = dict(K.launch_counts)
    K.mont_mul(field, a.to(dev), b.to(dev))
    assert K.launch_counts["mont_mul"] == before["mont_mul"] + 1


@pytest.mark.parametrize("message_bytes", [32, 64])
def test_blake2s_kernel(dev, message_bytes):
    g = torch.Generator().manual_seed(4)
    words = torch.randint(-(1 << 31), 1 << 31, (777, message_bytes // 4), generator=g,
                          dtype=torch.int32)
    mid = keyed_midstate()
    _same(K.blake2s(words.to(dev), message_bytes, mid),
          K.blake2s_plain(words, message_bytes, mid))


@pytest.mark.parametrize("name,size,cols,tw", _by_field(
    [(2, 3, "table"), (4, 3, "table"), (4, 1, "scalar"), (4, 5, None), (8, 1, "scalar"),
     (64, 5, None), (128, 7, "table"), (128, 1, "scalar")]))
def test_ntt_level_kernel(dev, name, size, cols, tw):
    field = FIELDS[name]
    if size > 1 << field.S:
        pytest.skip("domain larger than the field's 2-adicity")
    ops = LimbOps(field, "cpu")
    x = _canonical(field, (3, size, cols), 5)
    t = {"table": _canonical(field, (size, cols), 6), "scalar": _canonical(field, (), 7),
         None: None}[tw]
    w = dft_matrix(ops, size, False)
    got = K.ntt_level(field, x.to(dev), w.to(dev), None if t is None else t.to(dev))
    _same(got, K.ntt_level_plain(field, x, w, t))


# the radices a 16-limb level takes the limb body at, with ragged edges of
# its 8 x 32 tile: C not a multiple of 32, B * C = 1, a batch boundary
# inside a tile
BODY_CASES = [(128, 7, 3, "table"), (128, 1, 33, "scalar"), (128, 20, 1, "table"),
              (128, 1, 1, None), (64, 5, 2, None), (64, 16, 2, "scalar"), (32, 3, 5, "table"),
              (32, 1, 1, "scalar"), (32, 40, 1, None)]


@pytest.mark.parametrize("size,cols,bsz,tw", BODY_CASES)
def test_ntt_level_bodies_agree_with_the_plain_version(dev, size, cols, bsz, tw):
    field = F_STARK
    ops = LimbOps(field, "cpu")
    x = _canonical(field, (bsz, size, cols), 17)
    x[0, 0, 0] = 0xFFFF  # every byte at its largest, below p's top bit
    x[0, 0, 0, -1] = (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    t = {"table": _canonical(field, (size, cols), 18), "scalar": _canonical(field, (), 19),
         None: None}[tw]
    w = dft_matrix(ops, size, False)
    want = K.ntt_level_plain(field, x, w, t)
    xd, wd, td = x.to(dev), w.to(dev), None if t is None else t.to(dev)
    assert K.ntt_level_body(field, size) == "limb"
    for kwargs in ({}, {"body": "limb"}):
        before = (K.launch_counts["ntt_level"], K.ntt_level_body_counts["limb"])
        got = K.ntt_level(field, xd, wd, td, **kwargs)
        _same(got, want)
        assert K.launch_counts["ntt_level"] == before[0] + 1
        assert K.ntt_level_body_counts["limb"] == before[1] + 1


# the butterfly body's columns: C = 1 (a thread's S elements contiguous),
# B = 1, a block edge inside a batch (B C = 129, 200), both directions
BUTTERFLY_CASES = [(size, bsz, cols, tw, inverse) for size in (2, 4, 8)
                   for bsz, cols, tw, inverse in ((3, 43, "table", False),
                                                  (129, 1, "scalar", True), (1, 200, None, True),
                                                  (5, 1, None, False))]


@pytest.mark.parametrize("name,size,bsz,cols,tw,inverse", _by_field(BUTTERFLY_CASES))
def test_ntt_level_butterfly_body(dev, name, size, bsz, cols, tw, inverse):
    field = FIELDS[name]
    if size > 1 << field.S:
        pytest.skip("domain larger than the field's 2-adicity")
    ops = LimbOps(field, "cpu")
    x = _canonical(field, (bsz, size, cols), 27)
    t = {"table": _canonical(field, (size, cols), 28), "scalar": _canonical(field, (), 29),
         None: None}[tw]
    w = dft_matrix(ops, size, inverse)
    want = K.ntt_level_plain(field, x, w, t)
    assert torch.equal(K.ntt_level_butterfly_plain(field, x, w, t), want)
    xd, wd, td = x.to(dev), w.to(dev), None if t is None else t.to(dev)
    natural = K.ntt_level_body(field, size)
    assert natural == "butterfly"
    for body, kwargs in ((natural, {}), ("butterfly", {"body": "butterfly"}),
                         ("limb", {"body": "limb"})):
        before = (K.launch_counts["ntt_level"], dict(K.ntt_level_body_counts))
        _same(K.ntt_level(field, xd, wd, td, **kwargs), want)
        assert K.launch_counts["ntt_level"] == before[0] + 1
        assert K.ntt_level_body_counts[body] == before[1][body] + 1


def test_mont_mul_layouts(dev):
    """Each body of the mont_mul kernel: flat (contiguous, scalar, a view
    offset by one element, a strided 1-D view), grid (the LDE shift's
    broadcast form) and general (what collapses to neither)."""
    field = F_STARK
    a = _canonical(field, (2, 5, 70), 20)
    b = _canonical(field, (5, 70), 21)
    coeffs, pw = a[:, :1], b  # (2, 1, 70) x (5, 70): stride 0 on each side
    flat = a.reshape(-1, field.n16)
    cases = {
        "contiguous": (a, a.flip(0).contiguous()),
        "offset view": (flat[1:], flat[:-1]),
        "strided 1-D": (flat[0:699:3], flat[1:700:3]),
        "period": (a, b),
        "lde shift": (coeffs, pw),
        "general": (a.transpose(0, 2), b.transpose(0, 1)[:, :, None]),
        "narrow inner": (a[:, :, :3], b[:, 5:8]),
    }
    ad, bd = a.to(dev), b.to(dev)
    flat_d = ad.reshape(-1, field.n16)
    on_card = {
        "contiguous": (ad, ad.flip(0).contiguous()),
        "offset view": (flat_d[1:], flat_d[:-1]),
        "strided 1-D": (flat_d[0:699:3], flat_d[1:700:3]),
        "period": (ad, bd),
        "lde shift": (ad[:, :1], bd),
        "general": (ad.transpose(0, 2), bd.transpose(0, 1)[:, :, None]),
        "narrow inner": (ad[:, :, :3], bd[:, 5:8]),
    }
    for name, (x, y) in cases.items():
        xd, yd = on_card[name]
        assert xd.stride() == x.stride() and yd.stride() == y.stride(), name
        _same(K.mont_mul(field, xd, yd), K.mont_mul_plain(field, x, y))
        _same(K.addsub(field, xd, yd, "sub"), K.addsub_plain(field, x, y, "sub"))


@pytest.mark.parametrize("count", [1, 7, 1 << 16])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_pow_kernel(dev, name, count):
    field = FIELDS[name]
    ops = LimbOps(field, dev)
    x = _canonical(field, (count,), 22)
    x[0] = ops.one_m.cpu()
    xd = x.to(dev)
    e = field.p - 2
    before = K.launch_counts["mont_mul"]
    got = K.mont_pow(field, xd, e)
    assert K.launch_counts["mont_mul"] == before + 1  # one launch whatever e is
    _same(got, K.mont_pow_plain(field, xd, e))
    nonzero = ~ops.is_zero(xd)
    _same(ops.mul(got, xd)[nonzero], ops.one_m.expand(count, field.n16)[nonzero])
    for small in (0, 1, 2, 5):
        _same(K.mont_pow(field, xd[:7].contiguous(), small),
              K.mont_pow_plain(field, x[:7], small))
    before = K.launch_counts["mont_mul"]
    inv = ops.inv_fermat(xd[0])
    assert K.launch_counts["mont_mul"] == before + 1
    _same(inv, ops.one_m)


def _roots(shape, seed):
    """Random (..., 8) int32 root digests, the last all ones (every bit the
    challenge reads: the shave mask's)."""
    g = torch.Generator().manual_seed(seed)
    roots = torch.randint(-1 << 31, 1 << 31, shape + (8,), generator=g, dtype=torch.int64)
    roots = roots.to(torch.int32)
    roots.view(-1, 8)[-1] = -1
    return roots


def _tables(field, log_n, make, seed):
    """A PowerTwiddle of N = 2^log_n points whose entries come from
    make(shape, seed) (no powers of a root: the kernel only multiplies
    them), split as ntt/matmul.py power_twiddles splits."""
    shift = (1 << log_n).bit_length() // 2
    return K.PowerTwiddle(K.pack_words(make((1 << shift,), seed)),
                          K.pack_words(make((max(1, (1 << log_n) >> shift),), seed + 1)), shift)


def _on(tw, dev):
    return K.PowerTwiddle(tw.lo.to(dev), tw.hi.to(dev), tw.shift)


@pytest.mark.parametrize("half", [1, 3, 1001])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fri_fold_kernel(dev, name, half):
    field = FIELDS[name]
    values = _canonical(field, (2 * half,), 8)
    tw = _tables(field, 12, lambda shape, seed: _canonical(field, shape, seed), 9)
    roots = _roots((), 10)
    vd, twd = values.to(dev), _on(tw, dev)
    # the two halves of one tensor, then interleaved (row-strided) views
    for lo, hi, stride, first in ((slice(None, half), slice(half, None), 1, 0),
                                  (slice(0, None, 2), slice(1, None, 2), 4, 3)):
        before = K.launch_counts["fri_fold"]
        got = K.fri_fold(field, vd[lo], vd[hi], roots.to(dev), twd, stride, first)
        assert K.launch_counts["fri_fold"] == before + 1
        _same(got, K.fri_fold_round_plain(field, values[lo], values[hi], roots, tw, stride, first))
        _same(vd, values)  # the operands are read, never written


def _worst(field, shape):
    """Every element p - 1, in every limb."""
    top = [((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)]
    return torch.tensor(top, dtype=torch.int32).expand(shape + (field.n16,)).contiguous()


def _mixed(field, shape, seed):
    """Elements p - 1, 0 and 1 in turn from `seed` on, so that the operand
    pairs of every layout meet p - 1 against 0 (the subtraction borrows) and
    against 1 (the add wraps)."""
    count = 1
    for d in shape:
        count *= d
    values = torch.stack([_worst(field, ()), torch.zeros(field.n16, dtype=torch.int32),
                          torch.zeros(field.n16, dtype=torch.int32)])
    values[2, 0] = 1
    return values[(torch.arange(count) + seed) % 3].reshape(shape + (field.n16,))


def _addsub_layouts(field, make):
    """{label: (a, b)} of addsub's three bodies on operands from make(shape,
    seed): flat (contiguous; a scalar; offset and strided views of 1, 3,
    233 and 1029 elements: no multiple of a block), grid (a period over a
    row, the LDE shift's (R, 1, T) x (F, T)) and general (a transposed
    view; an inner dim under a warp)."""
    a, b = make((5, 2, 70), 30), make((2, 70), 31)
    flat, long = a.reshape(-1, field.n16), make((1031,), 35)
    return {
        "contiguous": (flat, flat.flip(0)),
        "scalar": (flat, make((), 32)),
        "1 element": (flat[:1], flat[1:2]),
        "3 elements": (flat[:3], flat[5:8]),
        "1029 elements, offset": (long[1:1030], long[2:]),
        "strided 1-D": (flat[0:699:3], flat[1:700:3]),
        "period": (a, b),
        "lde shift": (a[:2, :1], make((7, 70), 33)),
        "transposed": (a.transpose(0, 2), b.transpose(0, 1)[:, :, None]),
        "narrow inner": (a[:, :, :3], b[:, 5:8]),
    }


@pytest.mark.parametrize("inputs", ["random", "all p-1", "p-1, 0, 1"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_addsub_bodies(dev, name, inputs):
    """Each body of the addsub kernel at n16 = 4 and 16, both modes,
    against the plain version, with every body launched and counted."""
    field = FIELDS[name]

    def make(shape, seed):
        if inputs == "random":
            return _canonical(field, shape, seed)
        return _worst(field, shape) if inputs == "all p-1" else _mixed(field, shape, seed)

    seen = set()
    for label, (x, y) in _addsub_layouts(field, make).items():
        xd = _on_card(x)
        yd = _on_card(y)
        assert xd.stride() == x.stride() and yd.stride() == y.stride(), label
        body = K.addsub_body(xd, yd)
        assert body == K.mont_mul_body(x, y), label
        seen.add(body)
        for mode in ("add", "sub"):
            before = dict(K.addsub_body_counts)
            _same(K.addsub(field, xd, yd, mode), K.addsub_plain(field, x, y, mode))
            assert K.addsub_body_counts[body] == before[body] + 1, label
    assert seen == set(K.ADDSUB_BODIES)


def test_launch_stream_is_the_current_stream(dev):
    """The wrappers launch on torch's current stream: the default one, and
    a side stream made current, whose launch lands before its event."""
    assert K._stream() == torch.cuda.current_stream().cuda_stream
    field = F_P63
    a = _canonical(field, (1001,), 44).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert K._stream() == side.cuda_stream != torch.cuda.default_stream().cuda_stream
        got = K.addsub(field, a, a, "add")
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    assert torch.equal(got.cpu(), K.addsub_plain(field, a.cpu(), a.cpu(), "add"))


def _on_card(t):
    """t's storage on the card, viewed with t's shape, strides and offset."""
    storage = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
    return torch.as_strided(storage.to("cuda"), t.shape, t.stride(), t.storage_offset())


@pytest.mark.parametrize("inputs", ["random", "all p-1"])
@pytest.mark.parametrize("lanes,half", [(None, 1541), (None, 2), (3, 515), (2, 2049)])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fri_fold_kernel_ragged(dev, name, lanes, half, inputs):
    """Halves that are no multiple of a block, with and without lanes,
    every input p - 1 among them (values, tables, and a root of all
    ones), the two halves and the interleaved rows, strides below and
    above the tables' split and an offset that wraps the domain."""
    field = FIELDS[name]
    shape = (2 * half,) if lanes is None else (lanes, 2 * half)
    r_shape = () if lanes is None else (lanes,)
    if inputs == "random":
        make = lambda shape, seed: _canonical(field, shape, seed)  # noqa: E731
        roots = _roots(r_shape, 42)
    else:
        make = lambda shape, seed: _worst(field, shape)  # noqa: E731
        roots = torch.full(r_shape + (8,), -1, dtype=torch.int32)
    values, tw = make(shape, 40), _tables(field, 13, make, 41)
    vd, rd, twd = values.to(dev), roots.to(dev), _on(tw, dev)
    for lo, hi, stride, first in ((slice(None, half), slice(half, None), 1, 0),
                                  (slice(0, None, 2), slice(1, None, 2), 2, 4095),
                                  (slice(None, half), slice(half, None), 1 << 9, 5)):
        before = K.launch_counts["fri_fold"]
        got = K.fri_fold(field, vd[..., lo, :], vd[..., hi, :], rd, twd, stride, first)
        assert K.launch_counts["fri_fold"] == before + 1
        _same(got, K.fri_fold_round_plain(field, values[..., lo, :], values[..., hi, :], roots,
                                          tw, stride, first))


FOLD_SIZES = [(4, 0, None, 0), (4, 6, 2, 3), (8, 2, 3, (1 << 9) - 5), (12, 1, None, 1),
              (12, 14, None, 0), (16, 3, 2, 5), (20, 0, None, 0), (20, 4, 2, (1 << 19) + 7)]


@pytest.mark.parametrize("log_half,rnd,lanes,first", FOLD_SIZES)
@pytest.mark.parametrize("name", ["F_STARK", "F_BLS", "F_P63"])
def test_fri_fold_kernel_at_ladder_sizes(dev, name, log_half, rnd, lanes, first):
    """Halves of 2^4 to 2^20 rows in round `rnd` of a domain of
    2^(log_half + 1 + rnd) points, the tables the ladder reads
    (fold_twiddles, built on the card), rows from `first` on as a mesh
    block's (past the domain's end where first is large), with and
    without lanes: the kernel bit-equal to its plain version on the same
    card and to the old composition where the rows are few."""
    from hodor_tpu_torch.fri.fri import fold_pair_composed, fold_twiddles

    field = FIELDS[name]
    ops = LimbOps(field, dev)
    half, log_n = 1 << log_half, log_half + 1 + rnd
    shape = (2 * half,) if lanes is None else (lanes, 2 * half)
    values = _canonical(field, shape, 50 + log_half).to(dev)
    roots = _roots(() if lanes is None else (lanes,), 51).to(dev)
    tw = fold_twiddles(ops, log_n)
    lo, hi = values[..., :half, :], values[..., half:, :]
    got = K.fri_fold(field, lo, hi, roots, tw, 1 << rnd, first)
    _same(got, K.fri_fold_round_plain(field, lo, hi, roots, tw, 1 << rnd, first))
    if log_half <= 12:
        cpu = LimbOps(field, "cpu")
        for b in range(1 if lanes is None else lanes):
            pick = (lambda t: t) if lanes is None else (lambda t: t[b])
            want = fold_pair_composed(cpu, pick(lo).cpu(), pick(hi).cpu(), pick(roots).cpu(),
                                      1 << rnd, log_n, first)
            _same(pick(got), want)


LEVEL_CASES = [(2, 3, 5, "table"), (4, 3, 5, "table"), (4, 1, 7, None), (8, 1, 37, "scalar"),
               (64, 5, 2, None), (128, 7, 3, "table"), (128, 1, 33, "scalar")]


def _level_case(field, size, ccols, bsz, tw):
    """(x, folded W, its sums, twiddle) of one level case, on the CPU."""
    ops = LimbOps(field, "cpu")
    x = _canonical(field, (bsz, size, ccols), 12)
    t = {"table": _canonical(field, (size, ccols), 13), "scalar": _canonical(field, (), 14),
         None: None}[tw]
    w_s8, w_sum = folded_dft_matrix(ops, size, False)
    return ops, x, w_s8, w_sum, t


@pytest.mark.parametrize("name,size,ccols,bsz,tw", _by_field(LEVEL_CASES))
def test_wide_reduce_and_dft_reduce_kernels(dev, name, size, ccols, bsz, tw):
    field = FIELDS[name]
    ops, x, w_s8, w_sum, t = _level_case(field, size, ccols, bsz, tw)
    x_s8 = encode_s8(x).contiguous()
    cols = K.dft_columns_plain(w_s8, w_sum, x_s8)
    want = K.ntt_level_plain(field, x, dft_matrix(ops, size, False), t)
    assert torch.equal(K.wide_reduce_plain(field, cols, size, t), want)
    td = None if t is None else t.to(dev)
    _same(K.wide_reduce(field, cols.to(dev), size, td), want)
    _same(K.dft_reduce(field, w_s8.to(dev), w_sum.to(dev), x_s8.to(dev), size, td), want)


# ragged edges of the tensor-core body's 64 x 32 tile: Cc no multiple of 32
# with a batch boundary inside a tile, one output column, each radix it
# takes (at S = 32 the tile is 32 x 32)
DFT_BODY_CASES = [(128, 20, 3, "table"), (128, 1, 1, None), (128, 33, 2, "scalar"),
                  (64, 5, 2, None), (64, 40, 1, "table"), (32, 5, 7, "scalar"),
                  (32, 1, 1, "table")]


@pytest.mark.parametrize("size,ccols,bsz,tw", DFT_BODY_CASES)
def test_dft_reduce_bodies_agree_with_the_plain_version(dev, size, ccols, bsz, tw):
    field = F_STARK
    ops, x, w_s8, w_sum, t = _level_case(field, size, ccols, bsz, tw)
    x[0, 0, 0] = 0xFFFF  # every byte at its largest, below p's top bit
    x[0, 0, 0, -1] = (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    x_s8 = encode_s8(x).contiguous()
    want = K.ntt_level_plain(field, x, dft_matrix(ops, size, False), t)
    assert torch.equal(K.dft_reduce_plain(field, w_s8, w_sum, x_s8, size, t), want)
    assert torch.equal(K.dft_reduce_carry_plain(field, w_s8, w_sum, x_s8, size, t), want)
    args = (w_s8.to(dev), w_sum.to(dev), x_s8.to(dev), size, None if t is None else t.to(dev))
    assert K.dft_reduce_body(field, size) == "mma"
    for body, kwargs in (("mma", {}), ("mma", {"body": "mma"}), ("dp4a", {"body": "dp4a"})):
        before = (K.launch_counts["dft_reduce"], dict(K.dft_reduce_body_counts))
        _same(K.dft_reduce(field, *args, **kwargs), want)
        assert K.launch_counts["dft_reduce"] == before[0] + 1
        assert K.dft_reduce_body_counts[body] == before[1][body] + 1
    w16_s8, w16_sum = folded_dft_matrix(ops, 16, False)
    with pytest.raises(ValueError):
        K.dft_reduce(field, w16_s8.to(dev), w16_sum.to(dev),
                     encode_s8(x[:, :16]).contiguous().to(dev), 16, body="mma")


@pytest.mark.parametrize("size,ccols,bsz", [(128, 40, 2), (32, 7, 3)])
def test_dft_reduce_bodies_on_a_random_w(dev, size, ccols, bsz):
    """W is taken as it comes: random int8 (the top columns at byte 0, so
    that t stays under the reduction's bound) with the sums of its bytes."""
    g = torch.Generator().manual_seed(23)
    depth = size * 32
    w_s8 = torch.randint(-128, 128, (63, size, depth), generator=g, dtype=torch.int8)
    w_s8[60:] = -128
    w_sum = (w_s8.to(torch.int32) + 128).sum(dim=-1, dtype=torch.int32)
    x_s8 = torch.randint(-128, 128, (bsz, ccols, depth), generator=g, dtype=torch.int8)
    t = _canonical(F_STARK, (size, ccols), 24)
    want = K.dft_reduce_plain(F_STARK, w_s8, w_sum, x_s8, size, t)
    for body in ("mma", "dp4a"):
        _same(K.dft_reduce(F_STARK, w_s8.to(dev), w_sum.to(dev), x_s8.to(dev), size, t.to(dev),
                           body=body), want)


def test_s8dot_kernel_at_the_fused_level_shape(dev):
    """(8064, 4096) . (4096, 8192): all 63 columns of the folded W against
    2^13 columns of x, the product inside one fused level of 2^20 outputs."""
    g = torch.Generator().manual_seed(25)
    a = torch.randint(-128, 128, (8064, 4096), generator=g, dtype=torch.int8).to(dev)
    b = torch.randint(-128, 128, (4096, 8192), generator=g, dtype=torch.int8).to(dev)
    before = K.launch_counts["dft_reduce"]
    got = K.s8dot(a, b)
    assert K.launch_counts["dft_reduce"] == before + 1
    _same(got, K.s8dot_plain(a, b))


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (37, 50, 45), (1, 3, 1), (130, 129, 68),
                                   (64, 4096, 12)])
def test_s8dot_kernel(dev, m, k, n):
    g = torch.Generator().manual_seed(15)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    _same(K.s8dot(a.to(dev), b.to(dev)), K.s8dot_plain(a, b))
    assert torch.equal(K.s8dot_plain(a, b), a.to(torch.int32) @ b.to(torch.int32))


@pytest.mark.parametrize("log_n", [1, 7, 10, 15])
def test_level_forms_agree_on_the_card(dev, log_n):
    field = F_STARK
    x = _canonical(field, (3, 1 << log_n), 16).to(dev)
    outs = []
    for impl in ("level", "two_step", "fused"):
        ops = LimbOps(field, dev, impl)
        outs.append((ntt(ops, x), intt(ops, x)))
    for fwd, inv in outs[1:]:
        _same(fwd, outs[0][0])
        _same(inv, outs[0][1])


@pytest.mark.parametrize("name", ["fib_f257", "vdf_fstark_t32", "cubic_vdf_fstark_t32"])
def test_goldens_on_the_card(dev, name):
    from hodor_tpu_torch import air
    from hodor_tpu_torch.models import VDF, CubicVDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    if name == "fib_f257":
        field = F257
        fib = air.Fibonacci(field, final_b=5, at_step=3)
        tracer = air.TestTraceSystem(field)
        fib.trace(tracer)
        tracer.calculate_witness(1, 1, 3)
        witness, props = tracer.into_arp()
    elif name == "vdf_fstark_t32":
        field = F_STARK
        witness, props = VDF(field, 1, 2, 31).into_arp()
    else:
        field = F_STARK
        witness, props = CubicVDF(field, 1, 1, 31).into_arp()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
    proof = prover.prove(witness)
    assert Verifier(props, lde_factor=16).verify(proof)
    golden = os.path.join(os.path.dirname(__file__), "golden")
    with open(os.path.join(golden, f"{name}.proof"), "rb") as f:
        assert serialize_proof(proof, field) == f.read()
    with open(os.path.join(golden, f"{name}.challenges.json")) as f:
        expected = [tuple(e) for e in json.load(f)]
    assert [(k, v if isinstance(v, str) else str(v))
            for k, v in prover.last_transcript.log] == expected


@pytest.mark.parametrize("lanes,half", [(1, 1001), (3, 1001), (3, 3), (2, 128)])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fri_fold_kernel_with_lanes(dev, name, lanes, half):
    """(B, half, n16) halves with one root per lane, in one launch,
    against the plain version and against the kernel lane by lane."""
    field = FIELDS[name]
    values = _canonical(field, (lanes, 2 * half), 15)
    tw = _tables(field, 11, lambda shape, seed: _canonical(field, shape, seed), 16)
    roots = _roots((lanes,), 17)
    vd, twd, rd = values.to(dev), _on(tw, dev), roots.to(dev)
    for lo, hi in ((slice(None, half), slice(half, None)),
                   (slice(0, None, 2), slice(1, None, 2))):
        before = K.launch_counts["fri_fold"]
        got = K.fri_fold(field, vd[:, lo], vd[:, hi], rd, twd, 2, 1)
        assert K.launch_counts["fri_fold"] == before + 1
        _same(got, K.fri_fold_round_plain(field, values[:, lo], values[:, hi], roots, tw, 2, 1))
        for b in range(lanes):
            _same(got[b], K.fri_fold(field, vd[b, lo], vd[b, hi], rd[b], twd, 2, 1))
    _same(vd, values)


def test_batched_tree_on_the_card(dev):
    """A batch of trees built together: each lane's root and paths equal a
    tree of that lane alone, and equal the CPU's."""
    from hodor_tpu_torch.merkle.tree import MerkleTree, fetch_roots

    field = F_STARK
    leaves = _canonical(field, (3, 64), 19)
    batch = MerkleTree.create(leaves.to(dev), field)
    singles = [MerkleTree.create(leaves[b].to(dev), field) for b in range(3)]
    assert batch.get_roots() == fetch_roots(singles)
    assert batch.get_roots() == MerkleTree.create(leaves, field).get_roots()
    idx = torch.tensor([[1, 5], [62, 0], [33, 33]], device=dev)
    paths = batch.path_digests(idx)
    for b, tree in enumerate(singles):
        _same(paths[:, b], tree.path_digests(idx[b]))


@pytest.mark.parametrize("lanes", [None, 2])
def test_dropped_tree_opens_its_subtrees_on_the_card(dev, lanes, monkeypatch):
    """A 2^20-leaf tree dropped at its build (TREE_DROP_MIN set to 2^20)
    keeps its levels from 2^10 digests up; its paths, hashed again from
    the 2^10 rows under each index, equal the kept tree's, by its lanes and
    lane by lane, and after the kept tree's drop()."""
    from hodor_tpu_torch import profiling
    from hodor_tpu_torch.merkle import tree as tree_module

    field, n = F_STARK, 1 << 20
    values = _canonical(field, (n,) if lanes is None else (lanes, n), 29).to(dev)
    kept = tree_module.MerkleTree.create(values, field)
    monkeypatch.setattr(tree_module, "TREE_DROP_MIN", n)
    dropped = tree_module.MerkleTree.create(values, field)
    assert dropped.lost == 10 and dropped.levels[0].shape[-2] == 1 << 10
    assert dropped.get_roots() == kept.get_roots()
    idx = torch.tensor([0, n - 1, 2 * 346811, 2 * 346811 + 1], device=dev)
    if lanes is not None:
        idx = torch.stack([idx, idx.flip(0)])
    want = kept.path_digests(idx)
    profiling.reset_reopen_counts()
    got = dropped.path_digests(idx, values)
    _same(got, want)
    assert profiling.reopen_counts == {"openings": 1, "leaves_hashed": idx.numel() << 10}
    if lanes is not None:
        for b in range(lanes):
            _same(dropped.lane(b).path_digests(idx[b], values[b]), want[:, b])
    kept.drop()
    _same(kept.path_digests(idx, values), want)


def test_prove_batch_on_the_card(dev):
    """prove_batch of fib_f257 on two distinct lanes, on the card and on
    the CPU: the same proof bytes."""
    from hodor_tpu_torch import air
    from hodor_tpu_torch.errors import DivisionByZeroError
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover

    fib = air.Fibonacci(F257, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    witness, props = tracer.into_arp()
    cpu = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    for delta in range(1, 40):
        corrupted = [list(col) for col in witness]
        corrupted[0][2] = (corrupted[0][2] + delta) % F257.p
        try:
            want = [serialize_proof(p, F257) for p in cpu.prove_batch([witness, corrupted])]
            break
        except DivisionByZeroError:
            continue
    card = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
    before = K.launch_counts["fri_fold"]
    got = [serialize_proof(p, F257) for p in card.prove_batch([witness, corrupted])]
    assert K.launch_counts["fri_fold"] > before
    assert got == want and got[0] != got[1]


@pytest.mark.parametrize("size,cols,bsz,tw", [(4, 5, 3, "table"), (4, 1, 9, None),
                                               (2, 1, 9, "scalar"), (2, 5, 3, "table")])
@pytest.mark.parametrize("name", ["F_BLS", "F_P63"])
def test_level_kernels_at_worst_case_inputs(dev, name, size, cols, bsz, tw):
    """Every x = p - 1: the largest exact sums a level of these fields can
    see, where the limb body keeps u = (t + m p) / R in n16 limbs and drops
    the word above (csrc/field.cuh mont_reduce_wide). The limb body, the
    butterfly body and the two other level kernels against the plain
    version, which keeps that word."""
    field = FIELDS[name]
    ops = LimbOps(field, "cpu")
    top = torch.as_tensor([((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)],
                          dtype=torch.int32)
    x = top.expand(bsz, size, cols, field.n16).contiguous()
    t = {"table": top.expand(size, cols, field.n16).contiguous(), "scalar": top, None: None}[tw]
    w = dft_matrix(ops, size, False)
    want = K.ntt_level_plain(field, x, w, t)
    td = None if t is None else t.to(dev)
    _same(K.ntt_level(field, x.to(dev), w.to(dev), td, body="limb"), want)
    _same(K.ntt_level(field, x.to(dev), w.to(dev), td, body="butterfly"), want)
    w_s8, w_sum = folded_dft_matrix(ops, size, False)
    x_s8 = encode_s8(x).contiguous()
    _same(K.wide_reduce(field, K.dft_columns_plain(w_s8, w_sum, x_s8).to(dev), size, td), want)
    _same(K.dft_reduce(field, w_s8.to(dev), w_sum.to(dev), x_s8.to(dev), size, td), want)


@pytest.mark.parametrize("log_n", [9, 10])
def test_level_forms_agree_on_the_card_f_bls(dev, log_n):
    """The shared-body pass ("level") against radix-4 levels, radix 2 last
    at an odd log size ("two_step", "fused")."""
    x = _canonical(F_BLS, (2, 1 << log_n), 26).to(dev)
    outs = [(ntt(LimbOps(F_BLS, dev, impl), x), intt(LimbOps(F_BLS, dev, impl), x))
            for impl in ("level", "two_step", "fused")]
    for fwd, inv in outs[1:]:
        _same(fwd, outs[0][0])
        _same(inv, outs[0][1])


@pytest.mark.parametrize("name,lde_factor,fri", [("F_BLS", 16, 1), ("F_P63", 8, 4)])
def test_proof_bytes_on_the_card_equal_the_cpu(dev, name, lde_factor, fri):
    """A quadratic VDF of 2^10 rows: the card's proof bytes equal the CPU's
    (which tests/test_torch_fields.py holds against the scalar oracle at 32
    rows), and the card's proof verifies."""
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    field = FIELDS[name]
    witness, props = VDF(field, 1, 2, (1 << 10) - 1, witness="python").into_arp()
    blobs = []
    for device in (dev, "cpu"):
        prover = Prover(props.clone(), lde_factor=lde_factor, fri_final_degree_plus_one=fri,
                        device=device)
        proof = prover.prove(witness)
        blobs.append(serialize_proof(proof, field))
        assert Verifier(props, lde_factor=lde_factor).verify(proof)
    assert blobs[0] == blobs[1]


def test_bench_ntt_is_correct_on_the_card(dev):
    """tools/bench.py's ntt mode at 2^16 on the card: intt(ntt(x)) is x,
    the seeded outputs equal the host's values, the line names the card
    and reads a share of the H100's bound (its bytes at this size)."""
    from hodor_tpu_torch.tools import bench

    line, out = bench.bench_ntt(bench.parse_args(["--log-n", "16", "--reps", "2"]), dev)
    assert line["correct"] is True and out.device == dev
    assert line["metric"] == "ntt_2^16_F_STARK_field_muls_per_s_per_chip"
    assert 0 < line["vs_sol"] <= 1.05 and line["bound_by"] == "bytes"


def test_bench_prove_is_verified_on_the_card(dev):
    """tools/bench.py's prove mode at 2^10 rows on the card."""
    from hodor_tpu_torch.tools import bench

    line, proofs = bench.bench_prove(
        bench.parse_args(["--mode", "prove", "--log-rows", "10", "--reps", "1"]), dev)
    assert line["verified"] is True and len(proofs) == 1
    assert line["metric"] == "quadratic_vdf_2^10_rows_prove_wall_s" and line["peak_gib"] > 0


def _plain_passes(ops, x, inverse):
    """The shared plan's passes of a (B, N, n16) card tensor in the body's
    plain version (torch ops, on the card), natural order out."""
    field, (bsz, n, limbs) = ops.field, x.shape
    scale = ops.const(field.inv(n)) if inverse else None
    n1, n2 = M.shared_passes(ops, n)
    mid = K.ntt_level_shared_plain(field, x.view(bsz, n1, n2, limbs),
                                   M.pass_roots(ops, n1, inverse),
                                   M.power_twiddles(ops, n, inverse))
    out = K.ntt_level_shared_plain(field, mid.transpose(1, 2), M.pass_roots(ops, n2, inverse),
                                   scale)
    return out.reshape(bsz, n, limbs)


def _radix_levels(ops, x, inverse, monkeypatch):
    """The radix-128 plan of the same transform (the limb body at S = 128)."""
    with monkeypatch.context() as m:
        m.setattr(M, "SHARED_MIN_POINTS", 1 << 40)
        before = K.ntt_level_body_counts["limb"]
        got = intt(ops, x) if inverse else ntt(ops, x)
        assert K.ntt_level_body_counts["limb"] > before
    return got


@pytest.mark.parametrize("log_n,bsz,inverse", [(20, 2, False), (21, 1, False), (22, 1, False),
                                               (20, 1, True), (21, 1, True)])
def test_shared_body_at_the_main_path_shapes(dev, log_n, bsz, inverse, monkeypatch):
    """The transforms of a 2^20- and 2^22-row prove (two passes of 2^10 to
    2^11 points) bit-equal to the body's plain version and to the radix
    plan's limb levels; two launches of the shared body, no other."""
    ops = LimbOps(F_STARK, dev)
    x = _canonical(F_STARK, (bsz, 1 << log_n), 40 + log_n).to(dev)
    before = dict(K.ntt_level_body_counts)
    got = intt(ops, x) if inverse else ntt(ops, x)
    counts = {b: K.ntt_level_body_counts[b] - before[b] for b in K.NTT_LEVEL_BODIES}
    assert counts == {"butterfly": 0, "limb": 0, "shared": 2}
    _same(got, _plain_passes(ops, x, inverse))
    _same(got, _radix_levels(ops, x, inverse, monkeypatch))


def test_shared_body_writes_an_lde_coset_through_out(dev, monkeypatch):
    """One coset of a 2^20-row LDE at factor 16 written straight into its
    rows at stride 16 of the blown-up domain, the other rows untouched;
    and the LDE by coset equal to the batched one."""
    from hodor_tpu_torch import ntt as N

    ops = LimbOps(F_STARK, dev)
    x = _canonical(F_STARK, (2, 1 << 20), 61).to(dev)
    full = torch.full((2, 1 << 20, 16, 16), -1, dtype=torch.int32, device=dev)
    got = ntt(ops, x, out=full[:, :, 3])
    assert got.data_ptr() == full[:, :, 3].data_ptr()
    _same(full[:, :, 3], ntt(ops, x))
    assert bool((full[:, :, :3] == -1).all()) and bool((full[:, :, 4:] == -1).all())
    del full, got
    coeffs = x[:, : 1 << 16]
    batched = N.lde(ops, coeffs, 16, coset=True)
    monkeypatch.setattr(N, "LDE_SEQUENTIAL_MIN", 1)
    _same(N.lde(ops, coeffs, 16, coset=True), batched)


@pytest.mark.parametrize("name,log_n", [("F_STARK", 20), ("F_BLS", 16)])
def test_shared_body_at_worst_case_inputs(dev, name, log_n, monkeypatch):
    """Every x = p - 1, forward and inverse with 1/N, against the plain
    version and the radix plan."""
    field = FIELDS[name]
    ops = LimbOps(field, dev)
    top = torch.as_tensor([((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)],
                          dtype=torch.int32)
    x = top.expand(1, 1 << log_n, field.n16).contiguous().to(dev)
    for inverse in (False, True):
        got = intt(ops, x) if inverse else ntt(ops, x)
        _same(got, _plain_passes(ops, x, inverse))
        if name == "F_STARK":
            _same(got, _radix_levels(ops, x, inverse, monkeypatch))


def test_main_path_proof_through_the_shared_body(dev, monkeypatch):
    """A 2^20-row quadratic VDF: the proof bytes through the shared plan
    equal the radix plan's, and every transform of 2^8 points or more took
    the shared body (the FRI's last 16-point interpolation keeps its
    radix level)."""
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover

    witness, props = VDF(F_STARK, 1, 2, (1 << 20) - 1).into_arp()
    before = dict(K.ntt_level_body_counts)
    shared = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                    device=dev).prove(witness)
    counts = {b: K.ntt_level_body_counts[b] - before[b] for b in K.NTT_LEVEL_BODIES}
    assert counts["butterfly"] == 0 and counts["limb"] == 2 and counts["shared"] > 0
    monkeypatch.setattr(M, "SHARED_MIN_POINTS", 1 << 40)
    levels = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                    device=dev).prove(witness)
    assert serialize_proof(shared, F_STARK) == serialize_proof(levels, F_STARK)


def test_poseidon_proof_on_the_card_equals_the_cpu(dev):
    """The Poseidon chain at 2^12 rows (degree 3, 10 registers, lde 16):
    the card's proof bytes equal the CPU's (which
    tests/test_torch_poseidon.py holds against the plain reference at 2^7
    and 2^8 rows), and the card's proof verifies."""
    from hodor_tpu_torch.models import PoseidonChain
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    witness, props = PoseidonChain(F_STARK, 5, 7, (1 << 12) - 1).into_arp()
    blobs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)  # the CPU prove of 2^12 rows
    try:
        for device in (dev, "cpu"):
            proof = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                           device=device).prove(witness)
            blobs.append(serialize_proof(proof, F_STARK))
            assert Verifier(props, lde_factor=16).verify(proof)
    finally:
        torch.set_num_threads(threads)
    assert blobs[0] == blobs[1]


def test_fri_ladder_on_the_card_asks_nothing_of_the_host(dev, monkeypatch):
    """A quadratic VDF of 2^12 rows: the card's proof bytes equal the
    CPU's, and inside its ladder every fold is one fri_fold launch and no
    mont_mul; a warm ladder copies nothing from the host to the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hodor_tpu_torch.fri import fri as tfri
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    fold_pair, folds = tfri.fold_pair, []

    def counted(*args, **kwargs):
        before = dict(K.launch_counts)
        out = fold_pair(*args, **kwargs)
        folds.append({k: K.launch_counts[k] - before[k] for k in before})
        return out

    witness, props = VDF(F_STARK, 1, 2, (1 << 12) - 1, witness="python").into_arp()
    blobs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)  # the CPU prove of 2^12 rows
    try:
        for device in (dev, "cpu"):
            prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                            device=device)
            if device == dev:
                monkeypatch.setattr(tfri, "fold_pair", counted)
            proof = prover.prove(witness)
            monkeypatch.setattr(tfri, "fold_pair", fold_pair)
            blobs.append(serialize_proof(proof, F_STARK))
            assert Verifier(props, lde_factor=16).verify(proof)
    finally:
        torch.set_num_threads(threads)
    assert blobs[0] == blobs[1]
    assert len(folds) == 12 + 13  # h1 from 2^16 values, h2 from 2^17, to 16 points
    for launches in folds:
        assert launches["fri_fold"] == 1 and sum(launches.values()) == 1

    ops = LimbOps(F_STARK, dev)
    lde = _canonical(F_STARK, (1 << 16,), 60).to(dev)
    tfri.fri_chain(ops, lde, 12, 16)  # builds the tables
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tfri.fri_chain(ops, lde, 12, 16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("fri_fold_kernel" in n for n in names) == 12
    assert not [n for n in names if "HtoD" in n]
