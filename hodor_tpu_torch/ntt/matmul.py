"""Radix-128 four-step NTT built from DFT levels.

A length-N transform is log_128(N) levels of batched size-S DFTs with
elementwise twiddles between them (the four-step decomposition, as
hodor_tpu/ntt/matmul.py ntt_matmul). Each level is one launch of the
`ntt_level` kernel (field/kernels.py): the exact wide sum
sum_j W[k, j] x[j] against the Montgomery-form DFT matrix, one
Montgomery reduction per output, and the next level's twiddle fused in.
The inverse transform's 1/N rides in the terminal level as a scalar
twiddle.

Layout: a level reads x as (B, S, C, n16) and transforms axis 1, so the
four-step's first level runs on the (B, n1, n2) reshape of the input
with no transpose; only the recombination into natural order copies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..domain import Domain
from ..field import kernels
from ..field.field import Field
from ..field.limbs import LimbOps, int_to_limbs

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
        domain = Domain.new_for_size(ops.field, n)
        w = domain.generator_inv if inverse else domain.generator
        bases = ops.powers(ops.const(w), n1)  # (n1, L)
        ops.tables[key] = ops.powers(bases, n // n1)  # (n1, n2, L)
    return ops.tables[key]


def dft_level(ops: LimbOps, x, inverse: bool, tw=None):
    """Size-S DFT over axis 1 of a contiguous (B, S, C, n16) tensor, then
    the optional twiddle ((n16,) scalar or (S, C, n16) table)."""
    size = x.shape[1]
    return kernels.ntt_level(ops.field, x.contiguous(), dft_matrix(ops, size, inverse), tw)


def ntt_matmul(ops: LimbOps, x, inverse: bool = False, scale=None):
    """Natural-order NTT over axis -2 of (..., N, n16) using radix-128
    levels. scale: optional (n16,) Montgomery constant applied in the
    terminal level (the inverse transform's 1/N)."""
    n = x.shape[-2]
    if n & (n - 1):
        raise ValueError(f"ntt_matmul needs a power-of-two length, got {n}")
    L = x.shape[-1]
    lead = x.shape[:-2]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    radix = min(RADIX, max_radix(ops.field))
    if n == 1:
        return x if scale is None else ops.mul(x, scale)
    if n <= radix:
        out = dft_level(ops, x.reshape(b, n, 1, L), inverse, tw=scale)
        return out.reshape(x.shape)
    n1 = radix
    n2 = n // n1
    # j = j1*n2 + j2: DFT over j1 -> [k1, j2], times w_N^(k1*j2)
    inner = dft_level(ops, x.reshape(b, n1, n2, L), inverse,
                      tw=level_twiddles(ops, n, n1, inverse))
    # DFT over j2 per (b, k1) -> [k1, k2]
    outer = ntt_matmul(ops, inner.reshape(b * n1, n2, L), inverse, scale=scale)
    # natural order: out[k2*n1 + k1]
    out = outer.reshape(b, n1, n2, L).transpose(1, 2)
    return out.reshape(lead + (n, L))
