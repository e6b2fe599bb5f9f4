"""Number-theoretic transforms on the device.

All functions take and return Montgomery limb tensors of shape
(..., N, n16). Under the "level" form a 16-limb field's transform of 2^8
to 2^24 points runs as one or two passes of the shared body (the shared
plan of ntt/matmul.py); every other transform of length >= 2 runs
through the radix levels of ntt/matmul.py (radix 128, or 4 for the
fields whose wide sums allow no more). The canonical output equals the
JAX package's radix-2, Pease and matmul forms alike. The LDE is the reference's
`lde_using_multiple_cosets` (src/polynomials/mod.rs:418-482): one size-T
NTT per coset, interleaved into natural order on the blown-up domain;
above LDE_SEQUENTIAL_MIN limbs the cosets run one at a time, each NTT
written straight into its interleaved rows, so the temporaries are of
one coset's size.
"""

from __future__ import annotations

import torch

from ..domain import Domain
from ..field.limbs import LimbOps
from ..profiling import form_counts
from .matmul import intt_matmul, ntt_matmul

# An LDE whose batched form (..., factor, T, L) has at least this many
# int32 limbs runs one coset at a time (hodor_tpu's _LDE_SEQUENTIAL_MIN,
# ntt/__init__.py:292-330). Above every LDE of a 2^20-row prove (2^29 limbs
# at lde 16, 1.5 * 2^30 for six registers at lde 8, 2^30 for a batch of
# two), at the f- and g-LDEs of a 2^22-row one (2^31): set from the memory
# profile of those proves on an H100 80GB HBM3 (tools/memory_profile.py,
# PERF.md §6).
LDE_SEQUENTIAL_MIN = 1 << 31


def bit_reverse_indices(log_n: int, device="cuda") -> torch.Tensor:
    """(2^log_n,) int64 permutation on `device`: entry i is i with its
    log_n bits reversed."""
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(ops: LimbOps, a, inverse: bool = False, out=None):
    """Natural-order DFT over the 2^k domain: out[k] = sum_j a[j] w^(jk)
    (w = domain generator; w^-1 when inverse, without the 1/N scale -
    see `intt`). a: (..., N, L), N a power of two; out: an optional
    (..., N, L) int32 view to write the result into (ntt_matmul)."""
    return ntt_matmul(ops, a, inverse, out=out)


def intt(ops: LimbOps, a):
    """Inverse NTT including the 1/N scale (reference Polynomial::ifft,
    src/polynomials/mod.rs:773-797), the scale folded into the terminal
    level."""
    return intt_matmul(ops, a)


def distribute_powers(ops: LimbOps, a, g_limbs):
    """a[i] *= g^i - the coset-shift primitive (src/fft/mod.rs:110-123).
    g_limbs: (L,) Montgomery scalar. a: (..., N, L)."""
    return ops.mul(a, ops.powers(g_limbs, a.shape[-2]))


def coset_ntt(ops: LimbOps, a, gen_limbs=None):
    """NTT over the coset g*H (reference coset_fft,
    src/polynomials/mod.rs:626-638); g defaults to the field's
    multiplicative generator."""
    if gen_limbs is None:
        gen_limbs = ops.const(ops.field.generator)
    return ntt(ops, distribute_powers(ops, a, gen_limbs))


def icoset_ntt(ops: LimbOps, a, geninv_limbs=None):
    """Inverse of coset_ntt (reference icoset_fft,
    src/polynomials/mod.rs:799-815)."""
    if geninv_limbs is None:
        geninv_limbs = ops.const(ops.field.inv(ops.field.generator))
    return distribute_powers(ops, intt(ops, a), geninv_limbs)


def _coset_generators(ops: LimbOps, t: int, factor: int, coset: bool):
    """Generators of the `factor` sub-cosets of the blown-up domain:
    Omega^i (times the multiplicative generator for the coset variant),
    as a (factor, L) Montgomery tensor (src/polynomials/mod.rs:444-452
    and :565-574)."""
    big = Domain.new_for_size(ops.field, t * factor)
    gens = ops.powers(ops.const(big.generator), factor)
    if coset:
        gens = ops.mul(gens, ops.const(ops.field.generator))
    return gens


def lde(ops: LimbOps, coeffs, factor: int, coset: bool = False):
    """Low-degree extension by `factor` on the blown-up 2^k domain, in
    natural order: out[idx] = f((g*)Omega^idx), idx < T*factor - one NTT
    of size T per coset, interleaved as final[j*factor + c] = coset_c[j]:
    all cosets in one batched NTT, or one coset at a time where the
    batched form would hold LDE_SEQUENTIAL_MIN limbs or more.

    coeffs: (..., T, L) -> (..., T*factor, L)."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError(f"lde factor must be a power of two, got {factor}")
    if factor == 1:
        return coset_ntt(ops, coeffs) if coset else ntt(ops, coeffs)
    t = coeffs.shape[-2]
    L = coeffs.shape[-1]
    gens = _coset_generators(ops, t, factor, coset)  # (factor, L)
    if factor * coeffs.numel() < LDE_SEQUENTIAL_MIN:
        pw = ops.powers(gens, t)  # (factor, T, L)
        shifted = ops.mul(coeffs[..., None, :, :], pw)  # (..., factor, T, L)
        return _interleave(ntt(ops, shifted), t, factor, L)
    form_counts["ldes_by_coset"] += 1
    out = torch.empty(coeffs.shape[:-2] + (t * factor, L), dtype=torch.int32,
                      device=coeffs.device)
    by_coset = out.view(coeffs.shape[:-2] + (t, factor, L))
    for c in range(factor):
        ntt(ops, ops.mul(coeffs, ops.powers(gens[c], t)), out=by_coset[..., c, :])
    return out


def _interleave(evals, t: int, factor: int, L: int):
    """(..., factor, T, L) -> (..., T*factor, L) natural-order
    interleave: out[j*factor + c] = evals[c, j]."""
    lead = evals.shape[:-3]
    return evals.transpose(-3, -2).reshape(lead + (t * factor, L))


def evaluate_at(ops: LimbOps, coeffs, x_limbs):
    """Evaluate a coefficient-form polynomial at scalar x (reference
    Polynomial::evaluate_at, src/polynomials/mod.rs:685-711).
    coeffs: (N, L); x_limbs: (L,). Returns (L,)."""
    n = coeffs.shape[-2]
    return ops.sum_reduce(ops.mul(coeffs, ops.powers(x_limbs, n)), axis=-2)


def evaluate_at_domain_for_degree_one(ops: LimbOps, c0_limbs, c1_limbs, domain_size: int,
                                      coset: bool = False):
    """c0 + c1 x over the 2^k domain of `domain_size` points, or its coset
    by the field's multiplicative generator (reference
    src/polynomials/mod.rs:229-258 and :260-290). c0_limbs, c1_limbs:
    (L,) Montgomery scalars. Returns (domain_size, L)."""
    domain = Domain.new_for_size(ops.field, domain_size)
    start = ops.const(ops.field.generator) if coset else None
    xs = ops.powers(ops.const(domain.generator), domain.size, start=start)
    return ops.add(ops.mul(xs, c1_limbs), c0_limbs)
