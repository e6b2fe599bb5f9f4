"""ALIInstance: divisor precomputation, G composition, DEEP.

Semantic port of src/ali/per_register/mod.rs and
src/ali/per_register/deep.rs, as hodor_tpu/ali/instance.py arranges it:

- challenge draws are hoisted out of the compute (the reference draws
  (alpha, beta) per constraint *before* evaluating it, with no commits in
  between - src/ali/per_register/mod.rs:425-432 - so the whole challenge
  vector is known up front);
- the reference's per-term memoization of repeated (mask, power) coset
  LDEs (:379-398) is explicit: the distinct (mask, power) pairs are
  enumerated at instance build time and evaluated as one batched
  coset-LDE;
- IndexMap/IndexSet insertion orders (protocol-critical for Fiat-Shamir)
  are reproduced with Python dicts (insertion-ordered).

Constraint evaluation is one loop over the constraints and their terms
for every batch size: eager PyTorch has no traced program whose size a
scan would have to bound, and field sums are exact, so the values equal
both of the JAX package's forms.

Under a mesh (one rank of a torch.distributed job, parallel/) G's
composition runs on this rank's row block of the constraints domain:
the coset values and divisors keep only those rows, the term coset-LDEs
go through `sharded_coset_lde_rows` and the interpolant through
`sharded_icoset_ntt` (the JAX package's hooks and conditions,
hodor_tpu/ali/instance.py:497-518), and DEEP gives row blocks of h1 and
h2 on the blocks of the f- and g-LDEs.

DEEP keeps the points of an evaluation domain of up to XS_KEEP_MAX rows
in `ops.tables` for the prover's life; above that it builds them for the
call, XS_KEEP_MAX rows at a time, and runs its divisors, inverses and
products over those row chunks (hodor_tpu's _XS_INGRAPH_MIN form).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ..air.constraint import Constraint, UnivariateTerm
from ..air.density import density_divisor_spec, density_key
from ..arp import ARPInstance
from ..domain import Domain
from ..errors import DivisionByZeroError
from ..field.field import Field
from ..field.limbs import LimbOps, fetch_together
from ..ntt import distribute_powers, evaluate_at, icoset_ntt, lde
from ..parallel import gather_rows, local_rows, sharded_coset_lde_rows, sharded_icoset_ntt
from ..profiling import form_counts, span
from ..transcript import Blake2sTranscript

# The most rows (a rank's) of an evaluation domain whose points DEEP
# keeps; above it DEEP keeps none and works XS_KEEP_MAX rows at a time.
# At every LDE of a 2^20-row prove at lde 16 (f 2^24 rows, g 2^25), below
# the f- and g-LDEs of a 2^22-row one (2^26, 2^27): set from the memory
# profile of those proves on an H100 80GB HBM3 (tools/memory_profile.py,
# PERF.md §6).
XS_KEEP_MAX = 1 << 25


@dataclasses.dataclass(frozen=True)
class MaskProperties:
    """(register, mask) pair (src/ali/mod.rs:30-41)."""

    register_index: int
    mask: int  # canonical field int (omega^steps)


def get_masks_from_constraint(masks: Dict[MaskProperties, None], c: Constraint) -> None:
    """IndexSet-ordered mask collection (src/ali/mod.rs:58-105)."""
    for t in c.terms:
        unis = [t] if isinstance(t, UnivariateTerm) else t.terms
        for u in unis:
            assert u.steps_difference.kind == "mask"
            masks.setdefault(MaskProperties(u.register.index, u.steps_difference.value), None)


def get_mask_from_boundary_constraint(masks: Dict[MaskProperties, None], bc) -> None:
    masks.setdefault(MaskProperties(bc.register.index, 1), None)


class ALIInstance:
    """Precomputed ALI state + the two prover stages (G, DEEP)."""

    def __init__(self, arp: ARPInstance, mesh=None):
        """mesh: the DeviceMesh this rank proves under (parallel/), or
        None on one device."""
        props = arp.properties
        self.properties = props
        self.field: Field = props.field
        self.ops: LimbOps = arp.ops
        self.mesh = mesh
        self._ranks = mesh.size() if mesh is not None else 1
        self._rank = mesh.get_local_rank() if mesh is not None else 0

        self.max_constraint_power = max((c.degree for c in props.constraints), default=1)
        self.column_domain = Domain.new_for_size(self.field, props.num_rows)
        self.constraints_domain = Domain.new_for_size(
            self.field, self.column_domain.size * self.max_constraint_power
        )
        # the term and boundary coset-LDEs fill the constraints domain, the
        # degree rounded up to a power of two (4 at degree 3); the degree
        # adjustments keep the raw maximum
        self.term_lde_factor = self.constraints_domain.size // self.column_domain.size

        # ordered masks (constraints first, boundary last - the
        # reference's IndexSet fill order, src/ali/per_register/mod.rs:53-57
        # and :196-208)
        masks: Dict[MaskProperties, None] = {}
        for c in props.constraints:
            get_masks_from_constraint(masks, c)

        # ordered density batches (src/ali/per_register/mod.rs:163-171)
        self.batches: Dict[Tuple, List[Constraint]] = {}
        for c in props.constraints:
            self.batches.setdefault(density_key(c.density), []).append(c)

        for bc in props.boundary_constraints:
            get_mask_from_boundary_constraint(masks, bc)
        self.all_masks: List[MaskProperties] = list(masks.keys())
        self.mask_index = {m: i for i, m in enumerate(self.all_masks)}

        # distinct (mask_idx, power) LDE requirements (the reference's
        # WitnessEvaluationData memo key, src/ali/mod.rs:43-56)
        self.term_ldes: Dict[Tuple[int, int], int] = {}
        for c in props.constraints:
            for t in c.terms:
                unis = [t] if isinstance(t, UnivariateTerm) else t.terms
                for u in unis:
                    self.term_ldes.setdefault(self._term_key(u), len(self.term_ldes))

        # coset values of the constraints domain (PrecomputedOmegas.coset,
        # src/precomputations/mod.rs:48-60), inverse divisors per density
        # batch (src/ali/per_register/mod.rs:60-192) and boundary divisors
        # per distinct row (:210-227)
        rows: Dict[int, None] = {}
        for bc in props.boundary_constraints:
            rows.setdefault(bc.at_row, None)
        self._boundary_rows = list(rows.keys())
        self._precompute()

    def _term_key(self, u) -> Tuple[int, int]:
        return (self.mask_index[MaskProperties(u.register.index, u.steps_difference.value)],
                u.power)

    def _precompute(self) -> None:
        ops = self.ops
        field = self.field
        props = self.properties
        d_size = self.constraints_domain.size
        if d_size % self._ranks:
            raise ValueError(f"the constraints domain ({d_size} points) does not split "
                             f"into {self._ranks} row blocks")
        # under a mesh every table holds this rank's rows i of the D alone
        rows = d_size // self._ranks
        first = self._rank * rows
        g = self.column_domain.generator
        gen = self.constraints_domain.generator
        coset = ops.powers(
            ops.const(gen), rows,
            start=ops.const(field.mul(field.generator, field.pow(gen, first))),
        )  # (D/W, L): g_F w^i

        # vanishing-polynomial values per density batch over the coset
        # (air/density.py divisor form), inverted in one batch inverse;
        # subgroup-type densities (e > 0) are Z = x^e - c with the
        # excluded roots multiplied back after the inverse, sparse ones a
        # direct root product
        z_parts = []
        specs = []
        for key in self.batches:
            e, c_exp, excluded, included = density_divisor_spec(
                key, self.column_domain.size, props.num_rows
            )
            if e:
                roots = ops.encode([field.pow(g, r) for r in excluded]) if excluded else None
                z = ops.sub(ops.pow_static(coset, e), ops.const(field.pow(g, c_exp)))
            else:
                roots = ops.encode([field.pow(g, r) for r in included])
                z = ops.sub(coset, roots[0])
                for i in range(1, roots.shape[0]):
                    z = ops.mul(z, ops.sub(coset, roots[i]))
            z_parts.append(z)
            specs.append((key, e, roots))

        self.constraint_divisors: Dict[Tuple, torch.Tensor] = {}
        if z_parts:
            stacked = torch.stack(z_parts)  # (nkeys, D, L)
            inv_all = ops.batch_inverse(stacked.reshape(-1, ops.n16)).reshape(stacked.shape)
            for idx, (key, e, roots) in enumerate(specs):
                inv = inv_all[idx]
                if e and roots is not None:  # excluded roots (e > 0 only)
                    for i in range(roots.shape[0]):
                        inv = ops.mul(inv, ops.sub(coset, roots[i]))
                self.constraint_divisors[key] = inv

        self.boundary_divisors: Dict[int, torch.Tensor] = {}
        if self._boundary_rows:
            # 1/(x - root) for every boundary row, one batch inverse
            broots = ops.encode([field.pow(g, r) for r in self._boundary_rows])
            diffs = ops.sub(coset[None, :, :], broots[:, None, :])
            nb = diffs.shape[0]
            binv = ops.batch_inverse(diffs.reshape(nb * rows, -1)).reshape(nb, rows, -1)
            for i, row in enumerate(self._boundary_rows):
                self.boundary_divisors[row] = binv[i]
        self.coset_values = coset

    # ------------------------------------------------------------------- G

    def draw_g_challenges(self, transcript: Blake2sTranscript):
        """Draw (alpha, beta) per constraint (in density-batch order) then
        per boundary constraint - the exact reference order
        (src/ali/per_register/mod.rs:425-432 and :482-487)."""
        constraint_ch, boundary_ch = [], []
        with span("transcript"):
            for _key, batch in self.batches.items():
                for _ in batch:
                    a = transcript.get_challenge()
                    b = transcript.get_challenge()
                    constraint_ch.append((a, b))
            for _ in self.properties.boundary_constraints:
                a = transcript.get_challenge()
                b = transcript.get_challenge()
                boundary_ch.append((a, b))
        return constraint_ch, boundary_ch

    def calculate_g(self, transcript: Blake2sTranscript, witness_coeffs):
        """witness_coeffs: (R, T, L). Returns G in coefficient form (D, L),
        on every rank under a mesh. Draws challenges from the transcript
        exactly like the reference."""
        with span("ali.g"):
            constraint_ch, boundary_ch = self.draw_g_challenges(transcript)
            ops = self.ops
            return self._g_poly(
                witness_coeffs,
                ops.encode([a for a, _ in constraint_ch]),
                ops.encode([b for _, b in constraint_ch]),
                ops.encode([a for a, _ in boundary_ch]), ops.encode([b for _, b in boundary_ch]))

    def calculate_g_batch(self, transcripts, witness_coeffs_b):
        """Batched calculate_g (hodor_tpu/ali/instance.py calculate_g_batch):
        witness_coeffs_b (B, R, T, L), one transcript per proof, each drawing
        its challenges in the reference order. Returns (B, D, L). Every
        product and sum covers all lanes in one launch; the divisors, the
        coset values and the adjustment tables are shared by the lanes."""
        ops = self.ops
        with span("ali.g"):
            ch = [self.draw_g_challenges(t) for t in transcripts]

            def rows(which, k):
                # (rows, B, L): row i holds alpha (k = 0) or beta (k = 1) of
                # constraint i (which = 0) or boundary constraint i (which = 1)
                # in every lane
                return ops.encode([[lane[which][i][k] for lane in ch]
                                   for i in range(len(ch[0][which]))])

            return self._g_poly(witness_coeffs_b, rows(0, 0), rows(0, 1), rows(1, 0), rows(1, 1))

    @staticmethod
    def _lane_scalar(t):
        """A challenge row as an operand against (..., D, L) values: (L,)
        for one proof, (B, 1, L) for a batch, broadcast over D."""
        return t if t.dim() == 1 else t[:, None, :]

    def _g_poly(self, witness_coeffs, c_alphas, c_betas, b_alphas, b_betas):
        """G's coefficients from the witness polys (R, T, L), or (B, R, T, L)
        with lanes, and the challenges: per constraint (C, L) or (C, B, L),
        per boundary constraint (nb, L) or (nb, B, L)."""
        ops = self.ops
        field = self.field
        d_size = self.constraints_domain.size // self._ranks  # this rank's rows
        L = ops.n16
        factor = self.term_lde_factor

        with span("ali.terms"):
            # 1. mask witness polys: f_m = witness[reg] with powers of mask
            #    distributed (src/ali/per_register/mod.rs:276-290)
            masked = []
            for m in self.all_masks:
                f = witness_coeffs[..., m.register_index, :, :]
                masked.append(f if m.mask == 1 else distribute_powers(ops, f, ops.const(m.mask)))
            # 2. batched coset-LDE of every distinct (mask, power) term
            #    (the memoized evaluate_univariate_term_into_values, :356-421)
            bases = torch.stack([masked[mi] for (mi, _pw) in self.term_ldes], dim=0)
            base_ldes = self._coset_lde(bases, factor)  # (K, [B,] D, L)
            term_vals = [ops.pow_static(base_ldes[k], pw)
                         for k, (_mi, pw) in enumerate(self.term_ldes)]

        # distinct adjustment powers -> x^adj tables, computed once each
        adj_pows = {}

        def adj_table(adj):
            if adj not in adj_pows:
                adj_pows[adj] = ops.pow_static(self.coset_values, adj)
            return adj_pows[adj]

        with span("ali.compose"):
            g_values = ops.zero_m.expand(d_size, L)
            ci = 0
            for key, batch in self.batches.items():
                batch_values = ops.zero_m.expand(d_size, L)
                for c in batch:
                    alpha = self._lane_scalar(c_alphas[ci])
                    beta = self._lane_scalar(c_betas[ci])
                    ci += 1
                    cvals = ops.const(c.constant_term % field.p).expand(d_size, L)
                    for t in c.terms:
                        unis = [t] if isinstance(t, UnivariateTerm) else t.terms
                        prod = None
                        for u in unis:
                            v = term_vals[self.term_ldes[self._term_key(u)]]
                            prod = v if prod is None else ops.mul(prod, v)
                        if t.coeff % field.p != 1:
                            prod = ops.mul(prod, ops.const(t.coeff % field.p))
                        cvals = ops.add(cvals, prod)
                    adjustment = self.max_constraint_power - c.degree
                    if adjustment == 0:
                        cvals = ops.mul(cvals, alpha)
                    else:
                        # alpha * x^adj + beta over the coset (:292-308)
                        adj = ops.add(ops.mul(adj_table(adjustment), alpha), beta)
                        cvals = ops.mul(cvals, adj)
                    batch_values = ops.add(batch_values, cvals)
                batch_values = ops.mul(batch_values, self.constraint_divisors[key])
                g_values = ops.add(g_values, batch_values)

        # boundary constraints (:480-524), batched: one coset-LDE of all
        # shifted register polys, one adjustment/divisor pass
        bcs = self.properties.boundary_constraints
        if bcs:
            with span("ali.boundary"):
                nb = len(bcs)
                lane_dims = (1,) * (witness_coeffs.dim() - 3)  # () or (1,) for a batch
                wstack = torch.stack([witness_coeffs[..., bc.register.index, :, :] for bc in bcs])
                bvals = ops.encode([bc.value % field.p for bc in bcs])  # (nb, L)
                wstack[..., 0, :] = ops.sub(wstack[..., 0, :],
                                            bvals.reshape((nb,) + lane_dims + (L,)))
                cvals = self._coset_lde(wstack, factor)  # (nb, [B,] D, L)
                adjustment = self.max_constraint_power - 1
                if adjustment == 0:
                    cvals = ops.mul(cvals, b_alphas[..., None, :])
                else:
                    adj = ops.add(ops.mul(adj_table(adjustment)[None], b_alphas[..., None, :]),
                                  b_betas[..., None, :])
                    cvals = ops.mul(cvals, adj)
                bdiv = torch.stack([self.boundary_divisors[bc.at_row] for bc in bcs])
                cvals = ops.mul(cvals, bdiv.reshape((nb,) + lane_dims + (d_size, L)))
                g_values = ops.add(g_values, ops.sum_reduce(cvals, axis=0))

        # G interpolant (:526)
        with span("ali.interpolant"):
            return self._interpolant(g_values)

    def _coset_lde(self, coeffs, factor: int):
        """The term coset-LDE; under a mesh this rank's rows of it, the
        T-point NTTs row-sharded where T >= 2W (the JAX package's
        condition; the factor, term_lde_factor, is usually below W)."""
        if self.mesh is None:
            return lde(self.ops, coeffs, factor, coset=True)
        t = coeffs.shape[-2]
        if t % self._ranks == 0 and t >= 2 * self._ranks:
            return sharded_coset_lde_rows(self.ops, coeffs, factor, self.mesh)
        return local_rows(lde(self.ops, coeffs, factor, coset=True), self.mesh).clone()

    def _interpolant(self, g_values):
        """G's coefficients (D, L) from its values on the coset; under a
        mesh from this rank's rows of them, the D-point inverse transform
        row-sharded where D >= 2W, and the coefficients gathered onto every
        rank (one all_gather), since the G-LDE takes them replicated."""
        if self.mesh is None:
            return icoset_ntt(self.ops, g_values)
        if g_values.shape[-2] >= 2:
            return gather_rows(sharded_icoset_ntt(self.ops, g_values, self.mesh), self.mesh)
        return icoset_ntt(self.ops, gather_rows(g_values, self.mesh))

    # ---------------------------------------------------------------- DEEP

    def _draw_deep(self, transcript: Blake2sTranscript, n_f: int, n_g: int):
        """z and the mask alphas of one proof, in the reference order, and
        the divisor points m*z. The reference's batch_inversion returns Err
        when a divisor point falls in the evaluation domain (deep.rs:57-72,
        :129-146); an exact host check keeps a poisoned batch inverse out
        of DEEP."""
        field = self.field
        with span("transcript"):
            z = transcript.get_challenge()
            # the reference draws each alpha after its mask's evaluation but
            # with no commits in between, so all of them depend only on z
            # (deep.rs:78)
            alphas = [transcript.get_challenge() for _ in self.all_masks]
        roots = [field.mul(m.mask, z) for m in self.all_masks]
        for root in roots:
            if field.pow(root, n_f) == 1:
                raise DivisionByZeroError("mask*z lies in the f-LDE domain")
        if field.pow(z, n_g) == 1:
            raise DivisionByZeroError("z lies in the g-LDE domain")
        return z, alphas, roots

    def calculate_deep(self, witness_coeffs, f_ldes, g_poly, g_lde,
                       transcript: Blake2sTranscript):
        """Returns (h1_lde, h2_lde, f_at_z_m: List[int], g_at_z: int).
        Port of calculate_deep (src/ali/per_register/deep.rs:14-148).

        witness_coeffs (R, T, L), f_ldes (R, N_f, L), g_poly (D, L),
        g_lde (N_g, L); under a mesh f_ldes and g_lde are this rank's row
        blocks, and so are the h1 and h2 returned."""
        ops = self.ops
        with span("ali.deep_quotients"):
            z, alphas, roots = self._draw_deep(transcript, f_ldes.shape[-2] * self._ranks,
                                               g_lde.shape[-2] * self._ranks)
            return self._deep(witness_coeffs, f_ldes, g_poly, g_lde, ops.const(z),
                              ops.encode(alphas), ops.encode(roots))

    def calculate_deep_batch(self, witness_coeffs_b, f_ldes_b, g_poly_b, g_lde_b, transcripts):
        """Batched calculate_deep (hodor_tpu/ali/instance.py
        calculate_deep_batch): a leading lane axis B on every array, one
        transcript per proof; z, the alphas and the divisor points are per
        lane, DivisionByZeroError is raised for the first lane that hits
        it. Returns (h1 (B, N_f, L), h2 (B, N_g, L), f(mz) per lane, g(z)
        per lane), with one host fetch for all lanes."""
        ops = self.ops
        with span("ali.deep_quotients"):
            drawn = [self._draw_deep(t, f_ldes_b.shape[-2] * self._ranks,
                                     g_lde_b.shape[-2] * self._ranks) for t in transcripts]
            return self._deep(witness_coeffs_b, f_ldes_b, g_poly_b, g_lde_b,
                              ops.encode([z for z, _, _ in drawn]),
                              ops.encode([alphas for _, alphas, _ in drawn]),
                              ops.encode([roots for _, _, roots in drawn]))

    def _deep(self, witness_coeffs, f_ldes, g_poly, g_lde, z_m, alphas_m, roots_m):
        """DEEP on one proof or on B lanes: witness_coeffs ([B,] R, T, L),
        f_ldes ([B,] R, N_f, L), g_poly ([B,] D, L), g_lde ([B,] N_g, L);
        z_m ([B,] L), alphas_m and roots_m ([B,] M, L). Returns h1, h2 and
        the decoded f(mz) and g(z) (a list per lane with lanes)."""
        ops = self.ops
        regs = [m.register_index for m in self.all_masks]

        # f(m*z) per mask: batched polynomial evaluation (deep.rs:53)
        stacked = torch.stack([witness_coeffs[..., r, :, :] for r in regs], dim=-3)
        xpow = ops.powers(roots_m, stacked.shape[-2])  # ([B,] M, T, L)
        f_at_z_m = ops.sum_reduce(ops.mul(stacked, xpow), axis=-2)  # ([B,] M, L)
        del stacked, xpow

        # h1 = sum_m alpha_m * (f_lde[reg] - f(mz)) / (x - mz) on the
        # f-LDE domain (deep.rs:57-84); the domain points are plain
        # Omega^i. One mask at a time, so one mask's arrays are live, and
        # one chunk of rows at a time above XS_KEEP_MAX rows.
        n_f = f_ldes.shape[-2]
        h1_lde = None
        for rows in self._row_chunks(n_f):
            xs_f = self._domain_points(n_f, rows)
            part = None
            for i, r in enumerate(regs):
                inv_i = ops.batch_inverse(ops.sub(xs_f, self._lane_scalar(roots_m[..., i, :])))
                num_i = ops.sub(f_ldes[..., r, rows, :], self._lane_scalar(f_at_z_m[..., i, :]))
                term = ops.mul(ops.mul(num_i, self._lane_scalar(alphas_m[..., i, :])), inv_i)
                part = term if part is None else ops.add(part, term)
                del inv_i, num_i, term
            h1_lde = self._place(h1_lde, part, f_ldes[..., 0, :, :].shape, rows)
            del xs_f, part

        # h2 = (g_lde - g(z)) / (x - z) on the g-LDE domain (deep.rs:129-146)
        g_at_z = evaluate_at(ops, g_poly, z_m)  # ([B,] L)
        z_col = self._lane_scalar(z_m)
        g_col = self._lane_scalar(g_at_z)
        n_g = g_lde.shape[-2]
        h2_lde = None
        for rows in self._row_chunks(n_g):
            den = ops.batch_inverse(ops.sub(self._domain_points(n_g, rows), z_col))
            h2_lde = self._place(h2_lde, ops.mul(ops.sub(g_lde[..., rows, :], g_col), den),
                                 g_lde.shape, rows)
            del den

        # one fetch for every lane's f(mz) and g(z)
        f_host, g_host = map(ops.decode, fetch_together([f_at_z_m, g_at_z]))
        if g_at_z.dim() == 1:
            return h1_lde, h2_lde, [int(v) for v in f_host], int(g_host)
        return (h1_lde, h2_lde, [[int(v) for v in lane] for lane in f_host],
                [int(v) for v in g_host])

    def _row_chunks(self, rows: int):
        """The row slices DEEP works through on an evaluation domain of
        `rows` rows (a rank's): all of them up to XS_KEEP_MAX, else chunks
        of XS_KEEP_MAX rows, counted as a DEEP that keeps no table."""
        if rows <= XS_KEEP_MAX:
            return [slice(0, rows)]
        form_counts["deep_tables_not_kept"] += 1
        return [slice(r0, min(r0 + XS_KEEP_MAX, rows)) for r0 in range(0, rows, XS_KEEP_MAX)]

    @staticmethod
    def _place(whole, part, shape, rows: slice):
        """DEEP's output from its row chunks: the part itself where it
        covers every row, else written into `whole` (made on the first
        chunk) at `rows`."""
        if part.shape[-2] == shape[-2]:
            return part
        if whole is None:
            whole = torch.empty(shape, dtype=torch.int32, device=part.device)
        whole[..., rows, :] = part
        return whole

    def _domain_points(self, rows: int, part: slice):
        """w^i for the rows i of `part` among this rank's `rows` rows of the
        evaluation domain of rows * W points (W = 1 on one device: [1, w,
        w^2, ...]). The points of all the rows are built once per LimbOps
        and kept; a part of them is built for the call."""
        n = rows * self._ranks
        first = self._rank * rows + part.start
        count = part.stop - part.start
        key = ("domain_points", n, first)
        if count == rows and key in self.ops.tables:
            return self.ops.tables[key]
        with span("domain_points"):
            g = Domain.new_for_size(self.field, n).generator
            start = self.ops.const(self.field.pow(g, first)) if first else None
            points = self.ops.powers(self.ops.const(g), count, start=start)
        if count == rows:
            self.ops.tables[key] = points
        return points
