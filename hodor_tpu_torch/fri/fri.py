"""FRI prover (by values), query producer, verifier.

The fold recurrence per round i over values v of length K
(src/fri/fri_on_values.rs:61-119):

    next[j] = (v[j] + v[j+K/2] + c * w^{-j*2^i} * (v[j] - v[j+K/2])) / 2

with w the FULL lde-domain generator; each round Merkle-commits `next`
and derives the next challenge from the root. A round is one launch of
the fri_fold kernel (field/kernels.py) and one tree: the kernel draws
the challenge from the previous root on the device, since FRI fold
challenges never touch the transcript, and makes each w from two tables
of the l0 domain's inverse roots (`fold_twiddles`, built once per
domain size), so no round copies to the device or waits for it.

Under a mesh (parallel/) the ladder runs on the ranks' row blocks of
h1 and h2 (parallel/fri.py), and the query walk opens its sharded layers
through the owners' blocks.

The ladder also runs for a batch of proofs at once (Prover.prove_batch,
the port of hodor_tpu/fri/fri.py fri_chain_pair_batch): the values carry
a leading lane axis, (B, N, L), and each round is one batched tree and
one fold launch for all lanes, each lane's challenge drawn from its own
root.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..domain import (
    Domain,
    coset_for_natural_index_and_size,
    index_and_size_for_next_domain,
    log2_floor,
)
from ..errors import InvalidValueError
from ..field import kernels
from ..field.field import Field
from ..field.limbs import LimbOps, fetch_together
from ..merkle.blake2s import digest_to_challenge_mont
from ..merkle.tree import (IopQuery, MerkleTree, digest_to_bytes, keep_roots, take_rows,
                           verify_path)
from ..ntt import intt, lde
from ..ntt.matmul import power_twiddles
from ..parallel.multihost import ShardedMerkleTree, sharded_openings
from ..profiling import span


@dataclasses.dataclass
class FRIProofPrototype:
    """All intermediate commitments/values (reference FRIProofPrototype,
    src/fri/mod.rs:106-125). Values stay on the device in Montgomery form.
    Under a mesh, a layer whose tree is a ShardedMerkleTree holds this
    rank's row block of its values, in the tree's owner order; the others
    (the ladder's tail) hold them whole."""

    l0_commitment: MerkleTree
    intermediate_commitments: List[MerkleTree]
    intermediate_values: list  # each (K, L) Montgomery tensor
    challenges: List[int]
    final_root: bytes
    final_coefficients: List[int]
    initial_degree_plus_one: int
    output_coeffs_at_degree_plus_one: int
    lde_factor: int

    def get_roots(self) -> List[bytes]:
        return [self.l0_commitment.get_root()] + [
            c.get_root() for c in self.intermediate_commitments
        ]

    def get_final_root(self) -> bytes:
        return self.final_root

    def get_final_coefficients(self) -> List[int]:
        return list(self.final_coefficients)


@dataclasses.dataclass
class FRIProof:
    """Queries + roots + final coefficients (reference FRIProof,
    src/fri/mod.rs:139-153)."""

    queries: List[IopQuery]
    roots: List[bytes]
    final_coefficients: List[int]
    initial_degree_plus_one: int
    output_coeffs_at_degree_plus_one: int
    lde_factor: int


def fold_twiddles(ops: LimbOps, log_domain: int) -> kernels.PowerTwiddle:
    """The inverse-root tables of the 2^log_domain l0 domain that every
    round's fold reads its twiddles from: W^-e for e < 2^shift and
    W^(-e 2^shift), about sqrt(N) entries each, the NTT plan's inverse
    power twiddles of that length (ntt/matmul.py), built on the first
    call into `ops.tables` and shared with the NTT where it holds them."""
    return power_twiddles(ops, 1 << log_domain, True)


def fold_round(ops: LimbOps, values, root, stride: int, log_domain: int):
    """One FRI fold (src/fri/fri_on_values.rs:70-105). values: (K, L), or
    (B, K, L) for a batch; root: the (8,) root digest of the tree whose
    challenge the fold draws, or (B, 8) one per lane. The two halves of
    `values` are read in place (fold_pair)."""
    half = values.shape[-2] // 2
    return fold_pair(ops, values[..., :half, :], values[..., half:2 * half, :], root, stride,
                     log_domain)


def fold_pair(ops: LimbOps, lo, hi, root, stride: int, log_domain: int, first: int = 0):
    """Rows first, first + 1, ... of a fold whose rows j pair lo[j - first]
    with hi[j - first] (the rows j and j + K/2 of the round's values), in
    one fri_fold launch: the challenge drawn from `root` and the twiddles
    w_j = W^(-j*stride) from j = first, W the generator of the
    2^log_domain l0 domain, both made by the kernel."""
    with span("fri.fold"):
        return kernels.fri_fold(ops.field, lo, hi, root, fold_twiddles(ops, log_domain), stride,
                                first)


def fold_pair_composed(ops: LimbOps, lo, hi, root, stride: int, log_domain: int,
                       first: int = 0):
    """`fold_pair` composed from the separate steps, as the ladder made
    them before the kernel drew its own inputs: the challenge from the
    root (digest_to_challenge_mont), the K/2 twiddles from `ops.powers`,
    then the explicit-twiddle fold (`kernels.fri_fold_plain`). The
    reference the kernel and its plain version are held to."""
    p = ops.field.p
    step = pow(Domain.new_for_size(ops.field, 1 << log_domain).generator_inv, stride, p)
    start = ops.const(pow(step, first, p)) if first else None
    w = ops.powers(ops.const(step), lo.shape[-2], start=start)
    c_scaled = ops.mul(digest_to_challenge_mont(ops, root), ops.two_inv_m)
    return kernels.fri_fold_plain(ops.field, lo, hi, w, c_scaled, ops.two_inv_m)


def fri_chain(ops: LimbOps, lde_values, num_steps: int, log_domain: int, first_round: int = 0):
    """The FRI prover ladder: commit the first layer, then per round one
    fold, which draws its challenge from the last root on the device, and
    one tree. lde_values (N, L), or (B, N, L): every lane's round in one
    tree build and one fold launch. first_round: the round the first
    layer is at (a mesh ladder's tail starts after its sharded rounds).

    Returns (trees, intermediate values, final coefficients (K, L) or
    (B, K, L))."""
    fold_twiddles(ops, log_domain)  # built here, if at all: no round builds a table
    with span("merkle.commit"):
        trees = [MerkleTree.create(lde_values, ops.field)]
    values = lde_values
    intermediate = []
    for i in range(first_round, first_round + num_steps):
        values = fold_round(ops, values, trees[-1].root_digest(), 1 << i, log_domain)
        with span("merkle.commit"):
            trees.append(MerkleTree.create(values, ops.field))
        intermediate.append(values)
    return trees, intermediate, intt(ops, values)


def open_entry(tree, values, idx):
    """One entry's query rows and full Merkle paths on the device: values
    (Q, L) and siblings (depth, Q, 8), or with lanes (B, Q, L) and
    (depth, B, Q, 8); a dropped tree hashes the subtrees of `values` under
    idx again."""
    return take_rows(values, idx), tree.path_digests(idx, values)


def gather_chain_queries(chain_data, idx_arrays):
    """Every round's query values and full Merkle paths. chain_data: list
    of (tree, committed values); idx_arrays: list of (Q,) int64 index
    tensors, or (B, Q) for a tree and values with B lanes. The entries
    whose tree is a ShardedMerkleTree (values this rank's block) are
    opened together, in one all_gather. Returns per entry (values (Q, L),
    siblings (depth, Q, 8)), or (B, Q, L) and (depth, B, Q, 8) with lanes,
    on the host, in one device-to-host copy.

    The entries are let go as they are opened: each slot of chain_data
    becomes None and each local tree drops its lower levels, so that where the
    caller holds no other reference an entry's values and tree are freed
    before the next entry is opened (hodor_tpu's per-oracle gathers)."""
    if not chain_data:
        return []
    sharded = [i for i, (tree, _) in enumerate(chain_data) if isinstance(tree, ShardedMerkleTree)]
    out = [None] * len(chain_data)
    if sharded:
        opened = sharded_openings(
            [chain_data[i] + (idx_arrays[i],) for i in sharded], chain_data[sharded[0]][0].mesh)
        for i, pair in zip(sharded, opened):
            out[i] = pair
            chain_data[i] = None
    for i, idx in enumerate(idx_arrays):
        if out[i] is None:
            out[i] = open_entry(*chain_data[i], idx)
            chain_data[i][0].drop()
            chain_data[i] = None
    host = fetch_together([t for pair in out for t in pair])
    return list(zip(host[0::2], host[1::2]))


def run_ladders(ops: LimbOps, ldes, lde_factor: int, output_coeffs_at_degree_plus_one: int,
                mesh=None):
    """The ladders of several LDEs (each (N, L), or (B, N, L) with lanes)
    back to back, then one host fetch of every root and every final
    coefficient vector. Under a mesh of W > 1 ranks each LDE is this
    rank's (N/W, L) row block and its ladder runs sharded
    (parallel/fri.py). Returns per LDE (initial degree + 1, trees,
    intermediate values, final coefficients on the host)."""
    if output_coeffs_at_degree_plus_one & (output_coeffs_at_degree_plus_one - 1):
        raise ValueError("output degree + 1 must be a power of two")
    if lde_factor & (lde_factor - 1):
        raise ValueError("lde factor must be a power of two")
    w = 1 if mesh is None else mesh.size()
    if w > 1:  # parallel/fri.py builds on this module
        from ..parallel.fri import sharded_fri_chain
    chains = []
    for lde_values in ldes:
        n = lde_values.shape[-2] * w
        idpo = n // lde_factor
        steps = log2_floor(idpo // output_coeffs_at_degree_plus_one)
        chain = (fri_chain(ops, lde_values, steps, log2_floor(n)) if w == 1 else
                 sharded_fri_chain(ops, lde_values, steps, log2_floor(n), mesh))
        chains.append((idpo,) + chain)
    trees = [tree for chain in chains for tree in chain[1]]
    with span("fri.fetch"):
        host = fetch_together([t.root_digest() for t in trees] + [chain[3] for chain in chains])
        keep_roots(trees, host[:len(trees)])
    return [(idpo, trees, inter, fc)
            for (idpo, trees, inter, _), fc in zip(chains, host[len(trees):])]


class NaiveFriIop:
    """Reference NaiveFriIop<F, TrivialBlake2sIOP> (src/fri/mod.rs:64-104)."""

    DEGREE = 2

    # --------------------------------------------------------- prover

    @staticmethod
    def proof_from_lde(ops: LimbOps, lde_values, lde_factor: int,
                       output_coeffs_at_degree_plus_one: int) -> FRIProofPrototype:
        """Port of src/fri/fri_on_values.rs:11-163. lde_values: (N, L)."""
        return NaiveFriIop.proofs_from_ldes(
            ops, [lde_values], lde_factor, output_coeffs_at_degree_plus_one)[0]

    @staticmethod
    def proofs_from_ldes(ops: LimbOps, ldes, lde_factor: int,
                         output_coeffs_at_degree_plus_one: int,
                         mesh=None) -> List[FRIProofPrototype]:
        """FRI prototypes for several polynomials (the prover's h1, h2):
        the ladders run back to back, then one host fetch brings every
        root. Under a mesh each LDE is this rank's row block (run_ladders)."""
        return [
            NaiveFriIop._assemble_prototype(
                ops, trees, inter, fc, idpo, output_coeffs_at_degree_plus_one, lde_factor)
            for idpo, trees, inter, fc in run_ladders(
                ops, ldes, lde_factor, output_coeffs_at_degree_plus_one, mesh)
        ]

    @staticmethod
    def proofs_from_lde_batches(ops: LimbOps, ldes, lde_factor: int,
                                output_coeffs_at_degree_plus_one: int):
        """The batched form of `proofs_from_ldes` (the port of
        hodor_tpu/fri/fri.py fri_chain_pair_batch): ldes each (B, N, L),
        one ladder per LDE for all lanes. Returns per LDE (the batched
        trees, the batched intermediate values, the B per-lane prototypes,
        whose trees and values are views of the batched ones)."""
        out = []
        for idpo, trees, inter, fc in run_ladders(
                ops, ldes, lde_factor, output_coeffs_at_degree_plus_one):
            protos = [
                NaiveFriIop._assemble_prototype(
                    ops, [t.lane(b) for t in trees], [v[b] for v in inter], fc[b], idpo,
                    output_coeffs_at_degree_plus_one, lde_factor)
                for b in range(fc.shape[0])
            ]
            out.append((trees, inter, protos))
        return out

    @staticmethod
    def _assemble_prototype(ops, trees, intermediate_values, final_coeffs,
                            initial_degree_plus_one, output_coeffs_at_degree_plus_one,
                            lde_factor) -> FRIProofPrototype:
        """Host-side prototype assembly from a ladder's outputs (one lane);
        final_coeffs: Montgomery limbs, on the host or the device."""
        field = ops.field
        with span("fri.prototype"):
            root_bytes = [tree.get_root() for tree in trees]
            # all tree challenges except the last tree's (the final fold
            # draws none, fri_on_values.rs:122)
            challenges = [field.from_be_with_shave(rb) for rb in root_bytes[:-1]]
            roots = root_bytes[1:]
            final_root = roots[-1] if roots else root_bytes[0]
            final_coeffs = [int(v) for v in ops.decode(final_coeffs)][
                :output_coeffs_at_degree_plus_one
            ]
        return FRIProofPrototype(
            l0_commitment=trees[0],
            intermediate_commitments=list(trees[1:]),
            intermediate_values=list(intermediate_values),
            challenges=challenges,
            final_root=final_root,
            final_coefficients=final_coeffs,
            initial_degree_plus_one=initial_degree_plus_one,
            output_coeffs_at_degree_plus_one=output_coeffs_at_degree_plus_one,
            lde_factor=lde_factor,
        )

    @staticmethod
    def proof_from_lde_through_coefficients(
        ops: LimbOps, lde_values, lde_factor: int, output_coeffs_at_degree_plus_one: int
    ) -> FRIProofPrototype:
        """Test cross-check prover (src/fri/mod.rs:156-249): fold in
        coefficient space, re-LDE and commit each round."""
        field = ops.field
        n = lde_values.shape[0]
        l0 = MerkleTree.create(lde_values, field)
        initial_degree_plus_one = n // lde_factor
        num_steps = log2_floor(initial_degree_plus_one // output_coeffs_at_degree_plus_one)

        coeffs = intt(ops, lde_values)[:initial_degree_plus_one]
        challenges = [l0.get_challenge_scalar_from_root()]
        intermediate_commitments: List[MerkleTree] = []
        intermediate_values = []
        roots: List[bytes] = []
        for _ in range(num_steps):
            c = ops.const(challenges[-1])
            # next[j] = a_{2j} + challenge * a_{2j+1}
            coeffs = ops.add(coeffs[0::2], ops.mul(coeffs[1::2], c))
            values = lde(ops, coeffs, lde_factor)
            tree = MerkleTree.create(values, field)
            roots.append(tree.get_root())
            challenges.append(tree.get_challenge_scalar_from_root())
            intermediate_commitments.append(tree)
            intermediate_values.append(values)

        challenges.pop()
        final_root = roots[-1] if roots else l0.get_root()
        final_coeffs = [int(v) for v in ops.decode(coeffs)]
        return FRIProofPrototype(
            l0_commitment=l0,
            intermediate_commitments=intermediate_commitments,
            intermediate_values=intermediate_values,
            challenges=challenges,
            final_root=final_root,
            final_coefficients=final_coeffs,
            initial_degree_plus_one=initial_degree_plus_one,
            output_coeffs_at_degree_plus_one=output_coeffs_at_degree_plus_one,
            lde_factor=lde_factor,
        )

    # --------------------------------------------------- query producer

    @staticmethod
    def query_plan(prototype: FRIProofPrototype, iop_values, natural_first_element_index: int):
        """Chain-walk bookkeeping for the query producer
        (src/fri/query_producer.rs:10-53): per round the (tree, values)
        pair and the coset indices to open. Returns (trees, cosets,
        chain_data, idx_arrays); the gather is left to the caller so
        several polynomials' plans share one fetch."""
        trees = [prototype.l0_commitment] + list(prototype.intermediate_commitments)
        values = [iop_values] + list(prototype.intermediate_values)
        cosets = NaiveFriIop.coset_walk(prototype, natural_first_element_index)
        chain_data = list(zip(trees, values))
        idx_arrays = [torch.tensor(c, dtype=torch.int64, device=iop_values.device)
                      for c in cosets]
        return trees, cosets, chain_data, idx_arrays

    @staticmethod
    def coset_walk(prototype: FRIProofPrototype, natural_first_element_index: int):
        """The coset to open in each round of the chain, from the l0
        domain down (src/fri/query_producer.rs:10-53)."""
        domain_size = prototype.initial_degree_plus_one * prototype.lde_factor
        domain_idx = natural_first_element_index
        cosets = []
        for _ in range(1 + len(prototype.intermediate_commitments)):
            cosets.append(coset_for_natural_index_and_size(domain_idx, domain_size))
            domain_idx, domain_size = index_and_size_for_next_domain(domain_idx, domain_size)
        return cosets

    @staticmethod
    def proof_from_gathered(prototype: FRIProofPrototype, trees, cosets, gathered,
                            ops: LimbOps) -> FRIProof:
        """Assemble an FRIProof from fetched (values, sibling paths)."""
        queries: List[IopQuery] = []
        roots: List[bytes] = []
        for tree, coset, (v, sibs) in zip(trees, cosets, gathered):
            vals_dec = ops.decode(v)  # (Q,) canonical ints
            for qi, idx in enumerate(coset):
                path = [digest_to_bytes(sibs[d, qi]) for d in range(sibs.shape[0])]
                queries.append(IopQuery(index=idx, value=int(vals_dec[qi]), path=path))
            roots.append(tree.get_root())
        return FRIProof(
            queries=queries,
            roots=roots,
            final_coefficients=prototype.get_final_coefficients(),
            initial_degree_plus_one=prototype.initial_degree_plus_one,
            output_coeffs_at_degree_plus_one=prototype.output_coeffs_at_degree_plus_one,
            lde_factor=prototype.lde_factor,
        )

    @staticmethod
    def prototype_into_proof(ops: LimbOps, prototype: FRIProofPrototype, iop_values,
                             natural_first_element_index: int) -> FRIProof:
        """Walk all rounds producing coset queries
        (src/fri/query_producer.rs:10-53)."""
        trees, cosets, chain_data, idx_arrays = NaiveFriIop.query_plan(
            prototype, iop_values, natural_first_element_index
        )
        gathered = gather_chain_queries(chain_data, idx_arrays)
        return NaiveFriIop.proof_from_gathered(prototype, trees, cosets, gathered, ops)

    # --------------------------------------------------------- verifier

    @staticmethod
    def verify_proof(proof: FRIProof, natural_element_index: int, expected_value: int,
                     field: Field) -> bool:
        return NaiveFriIop.verify_proof_queries(
            proof, natural_element_index, NaiveFriIop.DEGREE, expected_value, field
        )

    @staticmethod
    def verify_proof_queries(
        proof: FRIProof, natural_element_index: int, degree: int, expected_value: int,
        field: Field
    ) -> bool:
        """Host scalar re-fold per query (src/fri/verifier.rs:131-289)."""
        p = field.p
        two_inv = field.inv(2)
        domain = Domain.new_for_size(field, proof.initial_degree_plus_one * proof.lde_factor)
        domain_element = field.pow(domain.generator, natural_element_index)
        if field.pow(domain_element, domain.size) != 1:
            raise InvalidValueError("challenge element not in LDE domain")
        if field.pow(domain_element, domain.size // 2) == 1:
            raise InvalidValueError("challenge element not in LDE domain")

        omega = domain.generator
        omega_inv = field.inv(omega)
        expected = None
        domain_size = domain.size
        domain_idx = natural_element_index

        if len(proof.queries) % degree != 0:
            raise InvalidValueError("invalid number of queries")

        def horner(x):
            acc, power = 0, 1
            for c in proof.final_coefficients:
                acc = (acc + power * c) % p
                power = power * x % p
            return acc

        last_round = len(proof.roots) - 1
        for round_idx, root in enumerate(proof.roots):
            qs = proof.queries[round_idx * degree : (round_idx + 1) * degree]
            coset = coset_for_natural_index_and_size(domain_idx, domain_size)
            if len(coset) != 2:
                raise InvalidValueError("invalid coset size")
            for q in qs:
                if q.natural_index not in coset:
                    return False
            if round_idx == 0:
                for q in qs:
                    if q.natural_index == natural_element_index and q.value != expected_value:
                        return False
            for c, q in zip(coset, qs):
                if q.tree_index != c:
                    raise InvalidValueError("invalid tree index")
            for q in qs:
                if not verify_path(root, q.value, q.path, q.tree_index, field):
                    return False

            if expected is not None:
                if domain_idx not in coset:
                    return False
                matching = [q for q in qs if q.natural_index == domain_idx]
                if len(matching) != 1 or matching[0].value != expected:
                    return False

            if round_idx == last_round:
                # The last committed vector IS the claimed low-degree
                # polynomial: every queried point is checked against the
                # committed coefficients (hodor_tpu/fri/fri.py explains
                # how this generalizes the reference's output-degree-1
                # check).
                for c, q in zip(coset, qs):
                    if q.value != horner(field.pow(omega, c)):
                        return False
                return True

            challenge = field.from_be_with_shave(root)
            f_at_omega = qs[0].value
            f_at_minus_omega = qs[1].value
            divisor = field.pow(omega_inv, coset[0])
            v_even = (f_at_omega + f_at_minus_omega) % p
            v_odd = (f_at_omega - f_at_minus_omega) * divisor % p
            expected = (v_even + challenge * v_odd) * two_inv % p

            domain_idx, domain_size = index_and_size_for_next_domain(domain_idx, domain_size)
            omega = field.mul(omega, omega)
            omega_inv = field.mul(omega_inv, omega_inv)

        raise InvalidValueError("no FRI rounds present")

    @staticmethod
    def verify_prototype(ops: LimbOps, prototype: FRIProofPrototype, leaf_values,
                         natural_element_index: int) -> bool:
        """Full-values verifier for tests (src/fri/verifier.rs:10-129)."""
        field = ops.field
        p = field.p
        two_inv = field.inv(2)
        domain = Domain.new_for_size(field, prototype.initial_degree_plus_one * prototype.lde_factor)
        omega = domain.generator
        omega_inv = field.inv(omega)
        expected = None
        domain_size = domain.size
        domain_idx = natural_element_index

        all_values = [leaf_values] + list(prototype.intermediate_values)
        for vals, challenge in zip(all_values, prototype.challenges):
            coset = coset_for_natural_index_and_size(domain_idx, domain_size)
            f_at_omega = int(ops.decode(vals[coset[0]]))
            if expected is not None:
                if domain_idx not in coset:
                    return False
                if int(ops.decode(vals[domain_idx])) != expected:
                    return False
            f_at_minus_omega = int(ops.decode(vals[coset[1]]))
            divisor = field.pow(omega_inv, coset[0])
            v_even = (f_at_omega + f_at_minus_omega) % p
            v_odd = (f_at_omega - f_at_minus_omega) * divisor % p
            expected = (v_even + challenge * v_odd) * two_inv % p
            domain_idx, domain_size = index_and_size_for_next_domain(domain_idx, domain_size)
            omega = field.mul(omega, omega)
            omega_inv = field.mul(omega_inv, omega_inv)

        point = field.pow(omega, domain_idx)
        acc, power = 0, 1
        for c in prototype.final_coefficients:
            acc = (acc + power * c) % p
            power = power * point % p
        return acc == expected
