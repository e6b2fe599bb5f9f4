"""The plain reference prover: the proof of an AIR instance worked out
from its start values alone, in plain PyTorch, for the benchmark's judge.

It follows the protocol of matter-labs/hodor's prover (src/prover/mod.rs)
as the program under test implements it, byte for byte: the trace
commitment (witness polynomials, their LDE and its Merkle roots), the
ALI composition G on the constraints domain's coset and its commitment,
the DEEP values f(m z) and quotients h1 and h2, the FRI ladders of h1
and h2 to their final coefficients, the Fiat-Shamir transcript, the
query indices and every opening with its path. Where the program
computes a value pointwise, this computes the same field element
another way: the LDE as one transform of the zero-padded coefficients,
division by (X - a) on coefficients, the dense divisor from the few
values x^T takes on the coset.

An AIR is a module beside its configuration (configs/<name>.py) that
gives REGISTERS, CONSTRAINTS (each a list of terms (coeff, [(register,
step, power), ...]), dense over rows [0, rows - 1)), witness(p, start,
steps) and boundary(columns, steps).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .field import PlainField
from .hashing import Transcript, Tree, element_from_bytes, leaf_words, query_index
from .poly import divide_by_linear, domain_generator, evaluate_on, interpolate_from

FOLD_CHUNK = 1 << 22  # FRI fold outputs worked out at once


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _masks(air, boundary) -> List[Tuple[int, int]]:
    """(register, step) of every mask, in the protocol's order: first
    appearance over the constraints' terms, then each boundary
    constraint's register at step 0."""
    seen: Dict[Tuple[int, int], None] = {}
    for terms in air.CONSTRAINTS:
        for _coeff, factors in terms:
            for reg, step, _power in factors:
                seen.setdefault((reg, step), None)
    for reg, _row, _value in boundary:
        seen.setdefault((reg, 0), None)
    return list(seen)


def _degree(terms) -> int:
    return max(sum(power for _r, _s, power in factors) for _c, factors in terms)


def _opening(F: PlainField, tree: Tree, idx: int):
    digits, path = tree.opening(idx)
    return [idx, F.decode(digits[:, None])[0], [b.hex() for b in path]]


def _ladder(F: PlainField, values, lde_factor: int, final_dp1: int):
    """FRI by values: (trees, final coefficients) of the ladder of `values`
    (16, N) down to lde_factor * final_dp1 values."""
    p = F.p
    n = values.shape[1]
    steps = (n // lde_factor // final_dp1).bit_length() - 1
    w_inv = pow(domain_generator(F, n), -1, p)
    half_const = F.const(pow(2, -1, p))
    trees = [Tree(leaf_words(values))]
    for i in range(steps):
        c_half = F.const(element_from_bytes(trees[-1].root, p) * pow(2, -1, p) % p)
        half = values.shape[1] // 2
        step = pow(w_inv, 1 << i, p)
        folded = torch.empty((16, half), dtype=torch.int64, device=values.device)
        for j in range(0, half, FOLD_CHUNK):
            k = min(j + FOLD_CHUNK, half)
            lo, hi = values[:, j:k], values[:, half + j:half + k]
            twiddles = F.powers(step, k - j, start=pow(step, j, p))
            odd = F.mul(F.mul(F.sub(lo, hi), twiddles), c_half)
            folded[:, j:k] = F.add(F.mul(F.add(lo, hi), half_const), odd)
        values = folded
        trees.append(Tree(leaf_words(values)))
    final = F.decode(values)
    k = len(final)
    w_k_inv = pow(domain_generator(F, k), -1, p)
    k_inv = pow(k, -1, p)
    coeffs = [sum(v * pow(w_k_inv, i * j, p) for i, v in enumerate(final)) * k_inv % p
              for j in range(final_dp1)]
    return trees, coeffs


def _fri_queries(F: PlainField, trees: List[Tree], index: int):
    out = []
    size = trees[0].n
    for tree in trees:
        pair = sorted([index, (index + size // 2) % size])
        out += [_opening(F, tree, i) for i in pair]
        index, size = (index if index < size // 2 else index - size // 2), size // 2
    return out


def prove(F: PlainField, air, start, steps: int, lde_factor: int, final_dp1: int,
          log=None) -> dict:
    """The proof of the instance whose witness chain starts at `start`
    and runs `steps` steps, as a plain dict (the judge's form). log, if
    given, takes a line of seconds by stage."""
    p, g = F.p, F.generator
    clock = _Clock(F.device, log)
    columns = air.witness(p, start, steps)
    clock("witness chain")
    boundary = air.boundary(columns, steps)
    rows = len(columns[0])
    t = _next_pow2(rows)
    r = air.REGISTERS
    w_t = domain_generator(F, t)
    max_pow = max(_degree(terms) for terms in air.CONSTRAINTS)
    d = _next_pow2(t * max_pow)
    n_f, n_g = t * lde_factor, d * lde_factor

    # trace commitment
    witness = F.encode([v for col in columns for v in list(col) + [0] * (t - rows)])
    f_coeffs = interpolate_from(F, witness.reshape(16, r, t))
    f_trees = []
    for reg in range(r):
        f_trees.append(Tree(leaf_words(evaluate_on(F, f_coeffs[:, reg], n_f))))
    clock("trace commitment")
    tr = Transcript(p)
    for tree in f_trees:
        tr.commit(tree.root)
    ch = [(tr.challenge(), tr.challenge()) for _ in air.CONSTRAINTS]
    bch = [(tr.challenge(), tr.challenge()) for _ in boundary]

    # ALI: G's values on the coset g * <w_D>, then its coefficients
    w_d = domain_generator(F, d)
    on_coset = evaluate_on(F, f_coeffs, d, shift=g)  # (16, R, D)
    xs = F.powers(w_d, d, start=g)
    shift = d // t

    def masked(reg, step):
        return torch.roll(on_coset[:, reg], -step * shift, dims=-1)

    acc = F.zero.expand(16, d)
    for terms, (alpha, beta) in zip(air.CONSTRAINTS, ch):
        cv = None
        for coeff, factors in terms:
            prod = None
            for reg, step, power in factors:
                v = masked(reg, step)
                term = v
                for _ in range(power - 1):
                    term = F.mul(term, v)
                prod = term if prod is None else F.mul(prod, term)
            if coeff % p != 1:
                prod = F.mul(prod, F.const(coeff))
            cv = prod if cv is None else F.add(cv, prod)
        adj = max_pow - _degree(terms)
        factor = F.const(alpha) if adj == 0 else F.add(
            F.mul(_pow_vals(F, xs, adj), F.const(alpha)), F.const(beta))
        acc = F.add(acc, F.mul(cv, factor))
    # dense divisor over rows [0, rows - 1): Z = (x^T - 1) / prod (x - w^e),
    # e over the excluded rows; x^T cycles through d / t values on the coset
    cyc = [(pow(g, t, p) * pow(w_d, k * t, p) - 1) % p for k in range(shift)]
    inv_cyc = F.encode([pow(c, -1, p) for c in cyc]).repeat(1, d // shift)
    inv_z = inv_cyc
    for e in range(rows - 1, t):
        inv_z = F.mul(inv_z, F.sub(xs, F.const(pow(w_t, e, p))))
    g_vals = F.mul(acc, inv_z)
    # boundary constraints: (alpha x^adj + beta) (f - v) / (x - w^row) on
    # coefficients, then on the coset
    adj = max_pow - 1
    bpoly = torch.zeros((16, t + adj), dtype=torch.int64, device=F.device)
    for (reg, row, _value), (alpha, beta) in zip(boundary, bch):
        q, _ = divide_by_linear(F, f_coeffs[:, reg], pow(w_t, row, p))
        if adj == 0:
            bpoly[:, :t] = F.add(bpoly[:, :t], F.mul(q, F.const(alpha)))
        else:
            bpoly[:, adj:adj + t] = F.add(bpoly[:, adj:adj + t], F.mul(q, F.const(alpha)))
            bpoly[:, :t] = F.add(bpoly[:, :t], F.mul(q, F.const(beta)))
    g_vals = F.add(g_vals, evaluate_on(F, bpoly, d, shift=g))
    del on_coset, acc, inv_z
    g_coeffs = interpolate_from(F, g_vals, shift=g)
    g_tree = Tree(leaf_words(evaluate_on(F, g_coeffs, n_g)))
    tr.commit(g_tree.root)
    clock("composition")

    # DEEP
    z = tr.challenge()
    masks = _masks(air, boundary)
    alphas = [tr.challenge() for _ in masks]
    f_at_z = []
    h1 = None
    for (reg, step), alpha in zip(masks, alphas):
        q, value = divide_by_linear(F, f_coeffs[:, reg], pow(w_t, step, p) * z % p)
        f_at_z.append(F.decode(value)[0])
        term = F.mul(q, F.const(alpha))
        h1 = term if h1 is None else F.add(h1, term)
    h2, _ = divide_by_linear(F, g_coeffs, z)
    del f_coeffs, g_coeffs
    clock("deep")

    # FRI
    h1_trees, h1_final = _ladder(F, evaluate_on(F, h1, n_f), lde_factor, final_dp1)
    h2_trees, h2_final = _ladder(F, evaluate_on(F, h2, n_g), lde_factor, final_dp1)
    for trees, final in ((h1_trees, h1_final), (h2_trees, h2_final)):
        tr.commit(trees[-1].root)
        for c in final:
            tr.commit_element(c)
    clock("fri")
    x1 = query_index(tr.challenge_bytes(), n_f, lde_factor)
    x2 = query_index(tr.challenge_bytes(), n_g, lde_factor)
    proof = {
        "f_roots": [tree.root.hex() for tree in f_trees],
        "g_root": g_tree.root.hex(),
        "f_at_z": f_at_z,
        "h1_roots": [tree.root.hex() for tree in h1_trees],
        "h2_roots": [tree.root.hex() for tree in h2_trees],
        "h1_final": h1_final,
        "h2_final": h2_final,
        "f_queries": [_opening(F, tree, x1) for tree in f_trees],
        "g_query": _opening(F, g_tree, x2),
        "h1_queries": _fri_queries(F, h1_trees, x1),
        "h2_queries": _fri_queries(F, h2_trees, x2),
        "fri_shape": [[n_f // lde_factor, final_dp1, lde_factor],
                      [n_g // lde_factor, final_dp1, lde_factor]],
    }
    clock("openings")
    clock.report()
    return proof


class _Clock:
    """Seconds by stage of a reference proof, each stage ended by a
    synchronize on the card."""

    def __init__(self, device, log):
        import time

        self.now, self.device, self.log = time.perf_counter, device, log
        self.last, self.parts = self.now(), []

    def __call__(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()  # the next stage's arrays are of other sizes
        t = self.now()
        self.parts.append(f"{stage} {t - self.last:.3f}")
        self.last = t

    def report(self) -> None:
        if self.log is not None:
            self.log("# reference stages (s): " + ", ".join(self.parts))


def _pow_vals(F: PlainField, xs, e: int):
    out = xs
    for _ in range(e - 1):
        out = F.mul(out, xs)
    return out
