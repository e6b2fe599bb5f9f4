"""The NTT's plans: shared-body passes, or radix-128 four-step DFT levels.

A 16-limb field's transform of SHARED_MIN_POINTS to SHARED_MAX_POINTS
points (an F_STARK prove's trace, constraint and LDE transforms from
2^8 rows) under the "level" form runs as one pass of the shared body of
the `ntt_level` kernel up to 2^12 points, else two: radix-2 butterflies
in shared memory, the n1-point DFTs of the (n1, n2) reshape's columns
times the four-step twiddle w_N^(k1 j2) (from two tables of about
sqrt(N) entries), then the n2-point DFTs of its rows, written in natural
order straight into the output or the caller's `out=` view
(`_ntt_shared`). It reads roots of unity, no DFT matrix.

Every other transform (4-limb fields, short lengths, the "two_step" and
"fused" forms) is log_128(N) levels of batched size-S DFTs with
elementwise twiddles between them (the four-step decomposition, as
hodor_tpu/ntt/matmul.py ntt_matmul). A level computes, per output, the
exact wide sum sum_j W[k, j] x[j] against the Montgomery-form DFT
matrix, one Montgomery reduction, and the next level's twiddle. It has
three forms with the same limbs, chosen by `LimbOps.ntt_impl` (the JAX
package's choice at its _dft_matmul):

  "level"    one launch of the `ntt_level` kernel on the limbs, whose
             body the kernel's wrapper picks from the radix (radix-2
             butterflies in registers at S = 2, 4, 8, limb arithmetic on
             the integer pipe elsewhere);
  "two_step" the byte planes of x as int8 (minus 128) against the folded
             byte-plane DFT matrix in one library int8 product, the
             offset corrections, then the `wide_reduce` kernel;
  "fused"    the same encode, then the `dft_reduce` kernel, which
             contracts, corrects and reduces without the columns
             reaching device memory.

The inverse transform's 1/N rides in the terminal level as a scalar
twiddle.

Layout: a level reads x as (B, S, C, n16) and transforms axis 1, so the
four-step's first level runs on the (B, n1, n2) reshape of the input
with no transpose; in the radix plan the recombination into natural
order copies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..domain import Domain
from ..field import kernels
from ..field.field import Field
from ..field.limbs import LimbOps, int_to_limbs
from ..profiling import span

RADIX = 128


@lru_cache(maxsize=None)
def max_radix(field: Field) -> int:
    """Largest power-of-2 radix r with r * p^2 < 2^(32*n16), so that a
    level's wide sum fits 2*n16 limbs."""
    r = 128
    bound = 1 << (32 * field.n16)
    while r > 1 and r * field.p * field.p >= bound:
        r //= 2
    return r


def dft_matrix(ops: LimbOps, size: int, inverse: bool) -> torch.Tensor:
    """(size, size, n16) Montgomery DFT matrix W[k, j] = w^(kj), w the
    generator of the size-`size` domain (its inverse when `inverse`)."""
    key = ("dft", size, inverse)
    if key not in ops.tables:
        with span("ops.tables"):
            field = ops.field
            domain = Domain.new_for_size(field, size)
            w = domain.generator_inv if inverse else domain.generator
            pows = np.stack([
                int_to_limbs(field.to_mont(pow(w, t, field.p)), ops.n16) for t in range(size)
            ]).astype(np.int32)
            idx = np.outer(np.arange(size), np.arange(size)) % size
            ops.tables[key] = torch.from_numpy(np.ascontiguousarray(pows[idx])).to(ops.device)
    return ops.tables[key]


def level_twiddles(ops: LimbOps, n: int, n1: int, inverse: bool) -> torch.Tensor:
    """(n1, n // n1, n16) Montgomery twiddles T[k1, j2] = w_N^(k1*j2) for
    the four-step recombination, built on the device: the n1 bases
    w_N^k1, then n2 powers of each."""
    key = ("twiddle", n, n1, inverse)
    if key not in ops.tables:
        with span("ops.tables"):
            domain = Domain.new_for_size(ops.field, n)
            w = domain.generator_inv if inverse else domain.generator
            bases = ops.powers(ops.const(w), n1)  # (n1, L)
            ops.tables[key] = ops.powers(bases, n // n1)  # (n1, n2, L)
    return ops.tables[key]


def folded_dft_matrix(ops: LimbOps, size: int, inverse: bool):
    """The byte-plane DFT matrix with the plane convolution folded into it
    (hodor_tpu/ntt/matmul.py _dft_matrix_folded_s8), on the device:

      w_s8  (C, S, S * P) int8: w_s8[c, k, j * P + q] = byte c - q of
            W[k, j] minus 128 (byte 0, so -128, where c - q is outside
            [0, P)),
      w_sum (C, S) int32: the sum of those bytes (unshifted) per (c, k),

    with P = 2 n16 byte planes and C = 2 P - 1 base-256 columns. 33 MB of
    int8 at n16 = 16 and S = 128, built once per LimbOps."""
    key = ("dft_folded", size, inverse)
    if key not in ops.tables:
        with span("ops.tables"):
            limbs = dft_matrix(ops, size, inverse).cpu().numpy()  # (S, S, n16)
            planes = np.stack([limbs & 0xFF, limbs >> 8], axis=-1).reshape(size, size, -1)
            P = planes.shape[-1]
            C = 2 * P - 1
            w_s8 = np.full((C, size, size, P), -128, dtype=np.int8)
            w_sum = np.zeros((C, size), dtype=np.int32)
            row_sums = planes.sum(axis=1, dtype=np.int32)  # (S, P): over j
            for c in range(C):
                for q in range(max(0, c - P + 1), min(c, P - 1) + 1):
                    w_s8[c, :, :, q] = planes[:, :, c - q] - 128
                    w_sum[c] += row_sums[:, c - q]
            ops.tables[key] = (
                torch.from_numpy(w_s8.reshape(C, size, size * P)).to(ops.device),
                torch.from_numpy(w_sum).to(ops.device),
            )
    return ops.tables[key]


def encode_s8(x):
    """(B, S, C, n16) limbs -> (B, C, S * P) int8: the bytes of
    x[b, j, c] minus 128 at depth index j * P + q (q the byte's place,
    little-endian), the depth contiguous."""
    bsz, size, ccols, n16 = x.shape
    lo = ((x & 0xFF) - 128).to(torch.int8)
    hi = ((x >> 8) - 128).to(torch.int8)
    xb = torch.stack([lo, hi], dim=-1).reshape(bsz, size, ccols, 2 * n16)
    return xb.permute(0, 2, 1, 3).reshape(bsz, ccols, size * 2 * n16)


# the two-step level's int32 columns take 4 * (4 n16 - 1) bytes per
# element (252 at n16 = 16): a level is split so that one product writes
# at most this many elements (1 GiB of columns at n16 = 16)
TWO_STEP_MAX_ELEMENTS = 1 << 22


def _two_step_block(ops: LimbOps, x, inverse: bool, tw, out=None):
    """The two-step level of one (B, S, C, n16) block, table twiddle or
    none: encode, one int8 product, the corrections, wide_reduce."""
    bsz, size, ccols, _ = x.shape
    w_s8, w_sum = folded_dft_matrix(ops, size, inverse)
    planes, _, depth = w_s8.shape
    m = bsz * ccols
    m_pad = -(-m // 8) * 8  # the int8 product takes widths in multiples of 8
    x_s8 = encode_s8(x).reshape(m, depth)
    if m_pad != m:
        x_s8 = torch.cat([x_s8, x_s8.new_zeros((m_pad - m, depth))], dim=0)
    sx = x_s8.sum(dim=-1, dtype=torch.int32) + 128 * depth
    cols = torch._int_mm(w_s8.reshape(planes * size, depth), x_s8.t())  # (C * S, m_pad)
    # sum (w + 128)(x + 128) = dot + 128 sx[m] + 128 w_sum[c, k] - 128^2 depth
    cols += (128 * w_sum - 128 * 128 * depth).reshape(planes * size, 1)
    cols += (128 * sx)[None, :]
    if m_pad != m:
        cols = cols[:, :m].contiguous()
    return kernels.wide_reduce(ops.field, cols.reshape(planes, size, bsz, ccols), size, tw, out=out)


def _level_two_step(ops: LimbOps, x, inverse: bool, tw=None):
    """The two-step level. A scalar twiddle (the inverse transform's 1/N)
    is a separate mul after the reduce, a table rides in wide_reduce. The
    int32 columns are 252 bytes per element at n16 = 16, so a level above
    TWO_STEP_MAX_ELEMENTS is split over the batch, and over the columns
    where one batch entry alone is too large."""
    bsz, size, ccols, _ = x.shape
    scalar = tw if tw is not None and tw.dim() == 1 else None
    table = None if scalar is not None else tw
    out = torch.empty_like(x)
    if size * ccols <= TWO_STEP_MAX_ELEMENTS:
        step = max(1, TWO_STEP_MAX_ELEMENTS // (size * ccols))
        for b0 in range(0, bsz, step):
            _two_step_block(ops, x[b0:b0 + step], inverse, table, out=out[b0:b0 + step])
    else:
        step = max(1, TWO_STEP_MAX_ELEMENTS // size)
        for b0 in range(bsz):
            for c0 in range(0, ccols, step):
                part = None if table is None else table[:, c0:c0 + step].contiguous()
                out[b0:b0 + 1, :, c0:c0 + step] = _two_step_block(
                    ops, x[b0:b0 + 1, :, c0:c0 + step], inverse, part)
    return out if scalar is None else ops.mul(out, scalar)


def _level_fused(ops: LimbOps, x, inverse: bool, tw=None):
    size = x.shape[1]
    w_s8, w_sum = folded_dft_matrix(ops, size, inverse)
    return kernels.dft_reduce(ops.field, w_s8, w_sum, encode_s8(x).contiguous(), size, tw)


def dft_level(ops: LimbOps, x, inverse: bool, tw=None):
    """Size-S DFT over axis 1 of a (B, S, C, n16) tensor, then the
    optional twiddle ((n16,) scalar or (S, C, n16) table), in the form
    `ops.ntt_impl` names."""
    if ops.ntt_impl == "two_step":
        return _level_two_step(ops, x, inverse, tw)
    if ops.ntt_impl == "fused":
        return _level_fused(ops, x, inverse, tw)
    return kernels.ntt_level(ops.field, x.contiguous(), dft_matrix(ops, x.shape[1], inverse), tw)


def pass_roots(ops: LimbOps, size: int, inverse: bool) -> torch.Tensor:
    """(size / 2, n16 / 2) packed words of w^e, e < size / 2, w the
    generator of the size-`size` domain (its inverse when `inverse`): what
    a shared-body pass of that length reads in place of a DFT matrix."""
    key = ("roots", size, inverse)
    if key not in ops.tables:
        with span("ops.tables"):
            domain = Domain.new_for_size(ops.field, size)
            w = domain.generator_inv if inverse else domain.generator
            ops.tables[key] = kernels.pack_words(ops.powers(ops.const(w), size // 2))
    return ops.tables[key]


def power_twiddles(ops: LimbOps, n: int, inverse: bool) -> kernels.PowerTwiddle:
    """The four-step twiddles w_N^e, e < n, as two tables of about sqrt(n)
    entries each: w_N^lo and w_N^(hi 2^shift). The second is the first's
    leading n >> shift entries raised to 2^shift, one `mont_pow` launch in
    place of a second `powers`."""
    key = ("power_twiddle", n, inverse)
    if key not in ops.tables:
        with span("ops.tables"):
            domain = Domain.new_for_size(ops.field, n)
            w = domain.generator_inv if inverse else domain.generator
            shift = n.bit_length() // 2  # ceil(log2(n) / 2): n >> shift <= 2^shift
            lo = ops.powers(ops.const(w), 1 << shift)
            hi = ops.pow_static(lo[:max(1, n >> shift)], 1 << shift)
            ops.tables[key] = kernels.PowerTwiddle(kernels.pack_words(lo), kernels.pack_words(hi),
                                                   shift)
    return ops.tables[key]


# transforms of a 16-limb field from this length to SHARED_MAX_POINTS run
# as one or two passes of the shared body of ntt_level: on an H100 a pass
# of 2^8 points takes 0.06 ms against 0.13 for the radix levels; below,
# one launch either way (PERF.md section 6)
SHARED_MIN_POINTS = 1 << 8
SHARED_MAX_POINTS = 1 << (2 * kernels.SHARED_MAX_LOG)


def shared_passes(ops: LimbOps, n: int):
    """The pass lengths of a length-n transform in the shared body, one
    pass up to 2^12 points, else two (n1 <= n2, n1 n2 = n); None where the
    transform keeps the radix levels: a 4-limb field, the "two_step" and
    "fused" forms, lengths outside SHARED_MIN_POINTS .. SHARED_MAX_POINTS."""
    if (ops.ntt_impl != "level" or ops.n16 != 16
            or not SHARED_MIN_POINTS <= n <= SHARED_MAX_POINTS):
        return None
    log_n = n.bit_length() - 1
    if log_n <= kernels.SHARED_MAX_LOG:
        return (n,)
    return (1 << log_n // 2, n >> log_n // 2)


def _ntt_shared(ops: LimbOps, x, inverse: bool, scale, out, passes):
    """The transform in shared-body passes: the n1-point DFTs of the
    columns of the (n1, n2) reshape, times w_N^(k1 j2), into a (n1, n2)
    scratch; then the n2-point DFTs of its rows, times `scale`, written
    straight in natural order (out[k2 n1 + k1]) into `out` or a new
    tensor. One pass up to 2^12 points."""
    n, L = x.shape[-2:]
    lead = x.shape[:-2]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    xb = x.reshape(b, n, L)
    if out is None:
        res = torch.empty((b, n, L), dtype=torch.int32, device=x.device)
    else:
        res = out.view(b, n, L)
    if len(passes) == 1:
        kernels.ntt_level_shared(ops.field, xb.view(b, n, 1, L), pass_roots(ops, n, inverse),
                                 scale, out=res.view(b, n, 1, L))
    else:
        n1, n2 = passes
        mid = torch.empty((b, n1, n2, L), dtype=torch.int32, device=x.device)
        kernels.ntt_level_shared(ops.field, xb.view(b, n1, n2, L), pass_roots(ops, n1, inverse),
                                 power_twiddles(ops, n, inverse), out=mid)
        kernels.ntt_level_shared(ops.field, mid.transpose(1, 2), pass_roots(ops, n2, inverse),
                                 scale, out=res.view(b, n2, n1, L))
    return res.view(lead + (n, L)) if out is None else out


def level_sizes(field: Field, n: int):
    """The radices of the levels the radix plan runs for a length-n
    transform over `field`, in order (each level writes n outputs): the
    field's largest radix up to RADIX while more than one is left, then
    the rest; 128, 128, 64 for F_STARK at 2^20 (where the "level" form
    takes the shared plan instead: `shared_passes`). `ntt_matmul` takes
    its first level from here."""
    radix = min(RADIX, max_radix(field))
    sizes = []
    while n > radix:
        sizes.append(radix)
        n //= radix
    return sizes + ([n] if n > 1 else [])


def ntt_matmul(ops: LimbOps, x, inverse: bool = False, scale=None, out=None):
    """Natural-order NTT over axis -2 of (..., N, n16): the shared-body
    passes where `shared_passes` gives them, else radix-128 levels.
    scale: optional (n16,) Montgomery constant applied in the terminal
    level or pass (the inverse transform's 1/N). out: an optional
    (..., N, n16) int32 view (rows at any one stride) that the natural
    order is written into, in place of a new tensor."""
    n = x.shape[-2]
    if n & (n - 1):
        raise ValueError(f"ntt_matmul needs a power-of-two length, got {n}")
    passes = shared_passes(ops, n)
    if passes is not None:
        return _ntt_shared(ops, x, inverse, scale, out, passes)
    L = x.shape[-1]
    lead = x.shape[:-2]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    sizes = level_sizes(ops.field, n)
    if len(sizes) < 2:
        if n == 1:
            res = x if scale is None else ops.mul(x, scale)
        else:
            res = dft_level(ops, x.reshape(b, n, 1, L), inverse, tw=scale).reshape(x.shape)
        return res if out is None else out.copy_(res)
    n1 = sizes[0]
    n2 = n // n1
    # j = j1*n2 + j2: DFT over j1 -> [k1, j2], times w_N^(k1*j2)
    inner = dft_level(ops, x.reshape(b, n1, n2, L), inverse,
                      tw=level_twiddles(ops, n, n1, inverse))
    # DFT over j2 per (b, k1) -> [k1, k2]
    outer = ntt_matmul(ops, inner.reshape(b * n1, n2, L), inverse, scale=scale)
    # natural order: out[k2*n1 + k1]
    natural = outer.reshape(b, n1, n2, L).transpose(1, 2)
    if out is None:
        return natural.reshape(lead + (n, L))
    out.view(b, n2, n1, L).copy_(natural)
    return out


def intt_matmul(ops: LimbOps, x):
    """Inverse NTT over axis -2 of (..., N, n16) with the 1/N scale, which
    rides in the terminal level (made once per length into `ops.tables`)."""
    n = x.shape[-2]
    key = ("inv_n", n)
    if key not in ops.tables:
        ops.tables[key] = ops.const(ops.field.inv(n % ops.field.p))
    return ntt_matmul(ops, x, inverse=True, scale=ops.tables[key])
