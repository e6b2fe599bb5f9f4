"""Prover orchestration (reference: src/prover/mod.rs).

Precomputes ARP + ALI at construction (amortized across proofs, like
Prover::new, src/prover/mod.rs:46-64); `prove` runs the pipeline on the
Prover's device in five stages, each ending at a Fiat-Shamir commit
point (the protocol's sequential dependencies, src/prover/mod.rs:82-127):

  stage 1: witness iNTT + all f LDEs + all f Merkle trees -> roots
  stage G: G composition + G LDE + G tree                  -> root
  DEEP:    f(mz), g(z), h1 and h2 on their LDE domains
  FRI:     the fold/commit ladders of h1 and h2
  queries: every oracle opening in one gather and one fetch
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .ali import ALIInstance
from .arp import ARPInstance, InstanceProperties, Witness
from .field.limbs import LimbOps
from .fri import FRIProof, NaiveFriIop
from .fri.fri import gather_chain_queries
from .merkle.tree import IopQuery, MerkleTree, digest_to_bytes, fetch_roots
from .ntt import lde
from .profiling import StageTimer
from .transcript import Blake2sTranscript, bytes_to_challenge_index


@dataclasses.dataclass
class InstanceProof:
    """Reference InstanceProof (src/verifier/mod.rs:97-116)."""

    f_at_z_m: List[int]
    f_iop_roots: List[bytes]
    g_iop_root: bytes
    f_queries: List[IopQuery]
    g_query: IopQuery
    h1_iop_roots: List[bytes]
    h2_iop_roots: List[bytes]
    fri_proof_h1: FRIProof
    fri_proof_h2: FRIProof


class Prover:
    def __init__(self, properties: InstanceProperties, lde_factor: int,
                 fri_final_degree_plus_one: int, device, ntt_impl: str = "level"):
        """ntt_impl: the form of every NTT level of the prove, "level",
        "two_step" or "fused" (ntt/matmul.py); the proof bytes are the
        same under all three."""
        self.field = properties.field
        self.device = torch.device(device)
        self.ops = LimbOps(self.field, self.device, ntt_impl)
        self.arp = ARPInstance.from_instance(properties, self.ops)
        self.ali = ALIInstance(self.arp)
        self.lde_factor = lde_factor
        self.fri_final_degree_plus_one = fri_final_degree_plus_one

    def prove(self, witness: Witness) -> InstanceProof:
        """Full prove pipeline (src/prover/mod.rs:66-174). witness: the
        register columns as lists of canonical ints, or the native witness
        chains' (R, rows, 4) uint64 array (`ARPInstance.encode_witness`)."""
        ops = self.ops
        field = self.field
        transcript = Blake2sTranscript(field)
        # exposed for Fiat-Shamir audits (the golden-vector tests)
        self.last_transcript = transcript
        timer = StageTimer(self.device)
        self.last_timings = timer

        # 1+2. witness -> polys -> LDEs -> oracles (src/prover/mod.rs:69-80)
        with timer.stage("witness+f_ldes+f_oracles"):
            w_dev = self.arp.encode_witness(witness)
            witness_polys = self.arp.calculate_witness_polys(w_dev)  # (R, T, L)
            del w_dev
            f_ldes = lde(ops, witness_polys, self.lde_factor)  # (R, N_f, L)
            f_oracles = [MerkleTree.create(f_ldes[r], field) for r in range(f_ldes.shape[0])]
            f_iop_roots = fetch_roots(f_oracles)
        for rb in f_iop_roots:
            transcript.commit_bytes(rb)

        # 3+4. G composition + G LDE + oracle (src/prover/mod.rs:89-95)
        with timer.stage("g_composition+g_oracle"):
            g_poly = self.ali.calculate_g(transcript, witness_polys)  # (D, L)
            g_lde_vals = lde(ops, g_poly, self.lde_factor)
            g_oracle = MerkleTree.create(g_lde_vals, field)
            g_iop_root = g_oracle.get_root()
        transcript.commit_bytes(g_iop_root)

        # 5. DEEP (src/prover/mod.rs:99-106)
        with timer.stage("deep"):
            h1_lde, h2_lde, f_at_z_m, _g_at_z = self.ali.calculate_deep(
                witness_polys, f_ldes, g_poly, g_lde_vals, transcript
            )
        del witness_polys, g_poly

        # 6. FRI for h1 and h2 (src/prover/mod.rs:112-113)
        with timer.stage("fri_h1+h2"):
            h1_proto, h2_proto = NaiveFriIop.proofs_from_ldes(
                ops, [h1_lde, h2_lde], self.lde_factor, self.fri_final_degree_plus_one
            )

        # 7. commit final roots + coefficients (src/prover/mod.rs:118-127)
        for proto in (h1_proto, h2_proto):
            transcript.commit_bytes(proto.get_final_root())
            for el in proto.get_final_coefficients():
                transcript.commit_field_element(el)

        # 8. challenge indices (src/prover/mod.rs:129-139)
        x_h1 = bytes_to_challenge_index(
            transcript.get_challenge_bytes(), h1_lde.shape[0], self.lde_factor
        )
        x_h2 = bytes_to_challenge_index(
            transcript.get_challenge_bytes(), h2_lde.shape[0], self.lde_factor
        )

        # 9+10. all query openings: both FRI chains' coset walks
        # (src/prover/mod.rs:142-143) and the f/g oracle openings
        # (:146-151), one gather and one fetch
        with timer.stage("queries"):
            h1_plan = NaiveFriIop.query_plan(h1_proto, h1_lde, x_h1)
            h2_plan = NaiveFriIop.query_plan(h2_proto, h2_lde, x_h2)
            chain_data = h1_plan[2] + h2_plan[2]
            idx_arrays = h1_plan[3] + h2_plan[3]
            x1 = torch.tensor([x_h1], dtype=torch.int64, device=self.device)
            x2 = torch.tensor([x_h2], dtype=torch.int64, device=self.device)
            chain_data += [(o, f_ldes[r]) for r, o in enumerate(f_oracles)]
            chain_data.append((g_oracle, g_lde_vals))
            idx_arrays += [x1] * len(f_oracles) + [x2]
            gathered = gather_chain_queries(chain_data, idx_arrays)
            n1, n2 = len(h1_plan[2]), len(h2_plan[2])
            fri_proof_h1 = NaiveFriIop.proof_from_gathered(
                h1_proto, h1_plan[0], h1_plan[1], gathered[:n1], ops
            )
            fri_proof_h2 = NaiveFriIop.proof_from_gathered(
                h2_proto, h2_plan[0], h2_plan[1], gathered[n1:n1 + n2], ops
            )

            def opening(index, v, sibs):
                path = [digest_to_bytes(sibs[d, 0]) for d in range(sibs.shape[0])]
                return IopQuery(index=index, value=int(ops.decode(v[0])), path=path)

            f_queries = [opening(x_h1, v, s) for v, s in gathered[n1 + n2:-1]]
            g_query = opening(x_h2, *gathered[-1])

        return InstanceProof(
            f_at_z_m=f_at_z_m,
            f_iop_roots=f_iop_roots,
            g_iop_root=g_iop_root,
            f_queries=f_queries,
            g_query=g_query,
            h1_iop_roots=h1_proto.get_roots(),
            h2_iop_roots=h2_proto.get_roots(),
            fri_proof_h1=fri_proof_h1,
            fri_proof_h2=fri_proof_h2,
        )
