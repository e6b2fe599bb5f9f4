"""Plain polynomial transforms over a PlainField: the radix-2 NTT in
natural order, evaluation on a coset, and division by (X - a)."""

from __future__ import annotations

import torch

from .field import CHUNK, PlainField


def domain_generator(F: PlainField, n: int) -> int:
    """The generator of the order-n subgroup: the field's 2^s-th root of
    unity squared down, as the protocol picks it."""
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > F.s:
        raise ValueError(f"no subgroup of order {n}")
    return pow(F.root_of_unity, 1 << (F.s - log_n), F.p)


def _bit_reverse(n: int, device) -> torch.Tensor:
    log_n = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(F: PlainField, a: torch.Tensor, inverse: bool = False, n_out: int = 0) -> torch.Tensor:
    """(16, ..., m) coefficients -> values at w^k, k < n, in natural order
    (w the order-n generator; with `inverse`, w^-1 and the 1/n scale), the
    coefficients zero-padded to n = n_out (a power-of-two multiple of m)
    where it is given, else n = m."""
    n = n_out or a.shape[-1]
    lead = a.shape[1:-1]
    rev = _bit_reverse(n, a.device)
    m = n // a.shape[-1]
    # zero-padded from a.shape[-1] coefficients: after the bit reversal the
    # inputs sit at multiples of m, and the first levels, which only copy,
    # spread each over its block of m
    x = a.reshape(16, -1, a.shape[-1])[:, :, rev[::m]].repeat_interleave(m, dim=-1)
    w = domain_generator(F, n)
    if inverse:
        w = pow(w, -1, F.p)
    table = F.powers(w, max(n // 2, 1))
    while m < n:
        tw = table[:, ::n // (2 * m)][:, None, :m]  # (16, 1, m)
        view = x.view(16, -1, 2, m)
        step = max(1, CHUNK // m)
        for b0 in range(0, view.shape[1], step):
            for m0 in range(0, m, CHUNK):
                blk = (slice(None), slice(b0, b0 + step))
                cols = slice(m0, m0 + CHUNK)
                u = view[blk + (0, cols)]
                v = F.mul(view[blk + (1, cols)], tw[:, :, cols])
                hi = F.sub(u, v)
                view[blk + (0, cols)] = F.add(u, v)
                view[blk + (1, cols)] = hi
        m *= 2
    if inverse:
        x = F.mul(x, F.const(pow(n, -1, F.p)))
    return x.reshape((16,) + tuple(lead) + (n,))


def pad(a: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    out[..., :a.shape[-1]] = a
    return out


def evaluate_on(F: PlainField, coeffs: torch.Tensor, n: int, shift: int = 1) -> torch.Tensor:
    """The values of (16, ..., m) coefficients, m <= n, at shift * w^k for
    k < n (w of order n), in natural order."""
    if shift != 1:
        coeffs = F.mul(coeffs, F.powers(shift, coeffs.shape[-1]))
    m = coeffs.shape[-1]
    used = 1 << (m - 1).bit_length() if m > 1 else 1
    return ntt(F, pad(coeffs, used), n_out=n)


def interpolate_from(F: PlainField, values: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The coefficients whose values at shift * w^k are `values`."""
    coeffs = ntt(F, values, inverse=True)
    if shift != 1:
        coeffs = F.mul(coeffs, F.powers(pow(shift, -1, F.p), coeffs.shape[-1]))
    return coeffs


def divide_by_linear(F: PlainField, coeffs: torch.Tensor, a: int):
    """(16, n) coefficients of f -> (the coefficients of (f - f(a)) / (X - a),
    f(a) as (16, 1)). q_i = a^-(i+1) * sum_{j > i} f_j a^j."""
    n = coeffs.shape[-1]
    scaled = F.mul(coeffs, F.powers(a, n))
    tail = F.suffix_sums(scaled)
    value = F.add(scaled[:, :1], tail[:, :1])
    a_inv = pow(a, -1, F.p)
    return F.mul(tail, F.powers(a_inv, n, start=a_inv)), value
