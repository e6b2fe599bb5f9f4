"""Number-theoretic transforms on the device.

All functions take and return Montgomery limb tensors of shape
(..., N, n16). Every transform of length >= 2 runs through the radix-128
levels of ntt/matmul.py; its canonical output equals the JAX package's
radix-2, Pease and matmul forms alike. The LDE is the reference's
`lde_using_multiple_cosets` (src/polynomials/mod.rs:418-482): one size-T
NTT per coset, interleaved into natural order on the blown-up domain.
"""

from __future__ import annotations

from ..domain import Domain
from ..field.limbs import LimbOps
from .matmul import ntt_matmul


def ntt(ops: LimbOps, a, inverse: bool = False):
    """Natural-order DFT over the 2^k domain: out[k] = sum_j a[j] w^(jk)
    (w = domain generator; w^-1 when inverse, without the 1/N scale -
    see `intt`). a: (..., N, L), N a power of two."""
    return ntt_matmul(ops, a, inverse)


def intt(ops: LimbOps, a):
    """Inverse NTT including the 1/N scale (reference Polynomial::ifft,
    src/polynomials/mod.rs:773-797), the scale folded into the terminal
    level."""
    n = a.shape[-2]
    minv = ops.const(ops.field.inv(n % ops.field.p))
    return ntt_matmul(ops, a, inverse=True, scale=minv)


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
    of size T per coset, then the interleave
    final[j*factor + c] = coset_c[j].

    coeffs: (..., T, L) -> (..., T*factor, L)."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError(f"lde factor must be a power of two, got {factor}")
    if factor == 1:
        return coset_ntt(ops, coeffs) if coset else ntt(ops, coeffs)
    t = coeffs.shape[-2]
    L = coeffs.shape[-1]
    gens = _coset_generators(ops, t, factor, coset)  # (factor, L)
    pw = ops.powers(gens, t)  # (factor, T, L)
    shifted = ops.mul(coeffs[..., None, :, :], pw)  # (..., factor, T, L)
    return _interleave(ntt(ops, shifted), t, factor, L)


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
