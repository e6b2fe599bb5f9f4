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

A prove larger than its plain forms fit takes memory-bounded forms, each
picked by size against a module constant (profiling.form_counts counts
them): trees that keep only their top levels (merkle/tree.py TREE_DROP_MIN),
leaves hashed in chunks (merkle/blake2s.py HASH_CHUNK), LDEs one coset at
a time (ntt LDE_SEQUENTIAL_MIN) and DEEP's domain points not kept
(ali/instance.py XS_KEEP_MAX). At every size the query stage opens its
entries one at a time and lets each entry's values and tree go before
the next.

`prove(..., checkpoint_dir=...)` saves each of the first four stages as it
completes and resumes from the saved ones (checkpoint.py).
`prove_batch` proves several witnesses of one instance at once: every
array of a stage carries a leading lane axis, one lane per proof, and
each launch covers all lanes, so B proofs share one set of launches and
host syncs instead of B sets (the port of hodor_tpu/prover.py
prove_batch, which vmaps the same stages).

`Prover(..., mesh=...)` proves as one rank of a torch.distributed job
(parallel/): every rank runs `prove` on the same witness and returns the
same proof. Stage 1 and stage G hold the f- and g-LDEs and their trees
as row blocks (`sharded_lde`, `ShardedMerkleTree`); G's composition and
DEEP run on row blocks (ali/instance.py); the FRI ladders fold and commit
the ranks' row blocks of h1 and h2 down to a fixed tail
(parallel/fri.py), and every opening of a sharded layer or oracle comes
from its owner's block. A checkpoint under a mesh holds the same whole
arrays as on one device: rank 0 writes them, the blocks reaching it one
at a time, and a resume takes each rank's rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .ali import ALIInstance
from .arp import ARPInstance, InstanceProperties, Witness
from .checkpoint import ProveCheckpoint
from .errors import SynthesisError
from .field.limbs import LimbOps, from_numpy_limbs, to_numpy_limbs
from .fri import FRIProof, NaiveFriIop
from .fri.fri import gather_chain_queries
from .merkle.tree import IopQuery, MerkleTree, digest_to_bytes, fetch_roots
from .ntt import lde
from .parallel import (collective_snapshot, collectives_since, local_rows, rows_to_host,
                       sharded_lde)
from .parallel.fri import ladder_from_layers
from .parallel.multihost import ShardedMerkleTree
from .profiling import SpanRecorder, span
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


def _opening(ops: LimbOps, index: int, v, sibs) -> IopQuery:
    """An oracle opening from one gathered query: the value (1, L) and its
    sibling digests (depth, 1, 8)."""
    path = [digest_to_bytes(sibs[d, 0]) for d in range(sibs.shape[0])]
    return IopQuery(index=index, value=int(ops.decode(v[0])), path=path)


class Prover:
    # one id a prove (a batch's lanes share it), unique in the process
    _proof_ids = itertools.count()

    @staticmethod
    def from_config(properties: InstanceProperties, config, device="cuda") -> "Prover":
        """Construct from a ProofSystemConfig (config.py), the runtime
        analog of the reference's generic parameters, on `device` (this
        rank's device under the config's mesh)."""
        return Prover(properties, lde_factor=config.lde_factor,
                      fri_final_degree_plus_one=config.fri_final_degree_plus_one,
                      device=device, mesh=config.mesh)

    def __init__(self, properties: InstanceProperties, lde_factor: int,
                 fri_final_degree_plus_one: int, device="cuda", ntt_impl: str = "level",
                 mesh=None):
        """device: where the prove runs, the card unless the caller asks
        for "cpu". ntt_impl: the form of every NTT level of the prove,
        "level", "two_step" or "fused" (ntt/matmul.py); the proof bytes are
        the same under all three. mesh: a DeviceMesh (parallel.make_mesh)
        to prove over as one of its ranks, device being this rank's; the
        proof bytes are those of one device.

        The construction's spans ("prover.init") open the record of the
        next prove: a prove's record holds what this Prover did since its
        previous prove returned."""
        self._record = SpanRecorder(device)
        with self._record.active(), self._record.span("prover.init"):
            self.field = properties.field
            self.device = torch.device(device)
            if mesh is not None and mesh.device_type != self.device.type:
                raise ValueError(f"a mesh of {mesh.device_type} devices cannot prove on "
                                 f"{self.device}")
            self.mesh = mesh
            self.ops = LimbOps(self.field, self.device, ntt_impl)
            with span("arp.route"):
                self.arp = ARPInstance.from_instance(properties, self.ops)
            with span("ali.tables"):
                self.ali = ALIInstance(self.arp, mesh)
            self.lde_factor = lde_factor
            self.fri_final_degree_plus_one = fri_final_degree_plus_one

    @contextlib.contextmanager
    def _recording(self):
        """The record of a prove (`last_timings`): everything recorded since
        the previous prove returned, under a new proof id, and the
        module-level spans while the prove runs; a new record begins as
        it returns."""
        timer = self._record
        timer.proof = next(Prover._proof_ids)
        self.last_timings = timer
        try:
            with timer.active():
                yield timer
        finally:
            self._record = SpanRecorder(self.device)

    def _lde(self, coeffs):
        """The LDE of (..., T, L) coefficients by lde_factor; under a mesh
        this rank's row block of it, the coset axis split over the ranks
        where W divides the factor (hodor_tpu/prover.py:101-106)."""
        with span("lde"):
            if self.mesh is None:
                return lde(self.ops, coeffs, self.lde_factor)
            w = self.mesh.size()
            if self.lde_factor % w == 0 and coeffs.shape[-2] % w == 0:
                return sharded_lde(self.ops, coeffs, self.lde_factor, self.mesh)
            return local_rows(lde(self.ops, coeffs, self.lde_factor), self.mesh).clone()

    def _trees(self, values):
        """The oracles of (R, N, L) values (this rank's (R, N/W, L) row
        blocks under a mesh, one all_gather for all R roots)."""
        if self.mesh is None:
            return [MerkleTree.create(v, self.field) for v in values]
        return ShardedMerkleTree.create_many(values, self.field, self.mesh)

    def _commit(self, values):
        """The oracles of values (as `_trees`) and their roots, fetched in
        one copy."""
        with span("merkle.commit"):
            trees = self._trees(values)
            return trees, fetch_roots(trees)

    @contextlib.contextmanager
    def _stage(self, timer: SpanRecorder, name: str):
        """A timed stage; under a mesh its collectives' calls, bytes and
        seconds go into last_exchanges[name]."""
        before = collective_snapshot()
        with timer.stage(name):
            yield
        if self.mesh is not None:
            self.last_exchanges[name] = collectives_since(before)

    def _check_roots(self, trees, saved_roots: List[bytes], stage: str) -> None:
        """Trees rebuilt from a checkpoint's saved values, each root held to
        the saved one. The roots are the same on every rank of a mesh, so
        a mismatch raises on every rank alike."""
        if fetch_roots(trees) != list(saved_roots):
            raise SynthesisError(f"checkpoint stage {stage!r}: a tree rebuilt from the saved "
                                 "values has another root than the saved one")

    def _rows(self, arr):
        """A checkpoint's whole (..., N, n16) evaluation-domain array ->
        this rank's row block of it on the device (the whole array on one
        device); only those rows leave the host."""
        return from_numpy_limbs(arr if self.mesh is None else local_rows(arr, self.mesh),
                                self.device)

    def _to_file(self, t, order=None):
        """t as a checkpoint array, (..., n16) uint32 limbs: on one device
        as it is; under a mesh on rank 0 alone (None on the others), where
        order (an owner order) says that t is this rank's row block, whose
        whole array reaches rank 0 block by block (parallel.rows_to_host)."""
        if self.mesh is None:
            return to_numpy_limbs(t)
        if order is not None:
            t = rows_to_host(t, self.mesh, order)
        return None if self.mesh.get_local_rank() else to_numpy_limbs(t)

    def _save(self, ck: ProveCheckpoint, stage: str, arrays: dict, meta: dict) -> None:
        """Save a stage; under a mesh rank 0 writes, and every rank waits
        at a barrier until it has."""
        if self.mesh is None or self.mesh.get_local_rank() == 0:
            ck.save(stage, arrays, meta)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group())

    def _resume_fri(self, loaded, h1_lde, h2_lde):
        """The FRI prototypes of h1 and h2 from a checkpoint's "fri" stage
        (arrays, meta): each ladder's trees rebuilt from its saved layers
        (dropped by size as in a prove), their roots held to the saved
        ones."""
        arrays, meta = loaded
        protos = []
        for tag, lde_vals in (("h1", h1_lde), ("h2", h2_lde)):
            trees, inter = ladder_from_layers(
                self.ops, lde_vals, [arrays[f"{tag}_v{i}"]
                                     for i in range(int(meta[f"{tag}_rounds"]))], self.mesh)
            self._check_roots(trees, [digest_to_bytes(r) for r in arrays[f"{tag}_roots"]], "fri")
            protos.append(NaiveFriIop._assemble_prototype(
                self.ops, trees, inter, arrays[f"{tag}_fc"], trees[0].size // self.lde_factor,
                self.fri_final_degree_plus_one, self.lde_factor))
        return protos

    def _save_fri(self, ck: ProveCheckpoint, protos, transcript) -> None:
        """Save the FRI stage: every ladder's later layers, roots and final
        coefficients."""
        arrays = {}
        meta = {"transcript": transcript.snapshot()}
        for tag, proto in zip(("h1", "h2"), protos):
            meta[f"{tag}_rounds"] = len(proto.intermediate_values)
            for i, (tree, v) in enumerate(zip(proto.intermediate_commitments,
                                              proto.intermediate_values)):
                arrays[f"{tag}_v{i}"] = self._to_file(
                    v, tree.order if isinstance(tree, ShardedMerkleTree) else None)
            arrays[f"{tag}_roots"] = np.stack(
                [np.frombuffer(rb, dtype="<u4") for rb in proto.get_roots()])
            arrays[f"{tag}_fc"] = to_numpy_limbs(self.ops.encode([proto.final_coefficients])[0])
        self._save(ck, "fri", arrays, meta)

    def prove(self, witness: Witness, checkpoint_dir: Optional[str] = None) -> InstanceProof:
        """Full prove pipeline (src/prover/mod.rs:66-174). witness: the
        register columns as lists of canonical ints, or the native witness
        chains' (R, rows, 4) uint64 array (`ARPInstance.encode_witness`).

        checkpoint_dir (optional): persist each completed Fiat-Shamir
        stage (checkpoint.py) so that an interrupted prove resumes from
        the last stage boundary on a re-run with the same directory; the
        resumed proof is byte-identical. The files hold whole arrays, so a
        directory resumes on one device or under a mesh of any size, in
        either package. Under a mesh every rank reads the directory and
        rank 0 writes it: with ranks on several hosts it must lie on a
        file system that every rank sees."""
        with self._recording() as timer:
            return self._prove(timer, witness, checkpoint_dir)

    def _prove(self, timer: SpanRecorder, witness: Witness,
               checkpoint_dir: Optional[str]) -> InstanceProof:
        ops = self.ops
        field = self.field
        ck, done = None, []
        # the owner order of the evaluation-domain arrays' row blocks (for
        # _to_file): natural under a mesh, none on one device
        blocks = None if self.mesh is None else tuple(range(self.mesh.size()))
        if checkpoint_dir is not None:
            ck = ProveCheckpoint(checkpoint_dir)
            done = ck.completed_prefix()
            if self.mesh is not None:  # every rank reads before rank 0 writes
                dist.barrier(group=self.mesh.get_group())
        transcript = Blake2sTranscript(field)
        # exposed for Fiat-Shamir audits (the golden-vector tests)
        self.last_transcript = transcript
        self.last_exchanges = {}

        def load(stage):
            nonlocal transcript
            arrays, meta = ck.load(stage)
            transcript = Blake2sTranscript.restore(field, meta["transcript"])
            self.last_transcript = transcript
            return arrays, meta

        # 1+2. witness -> polys -> LDEs -> oracles (src/prover/mod.rs:69-80)
        if "stage1" in done:
            with timer.stage("witness+f_ldes+f_oracles(resumed)"):
                arrays, meta = load("stage1")
                witness_polys = from_numpy_limbs(arrays["witness_polys"], self.device)
                f_ldes = self._rows(arrays["f_ldes"])
                f_oracles = self._trees(f_ldes)
                f_iop_roots = [bytes.fromhex(h) for h in meta["f_roots"]]
                self._check_roots(f_oracles, f_iop_roots, "stage1")
        else:
            with self._stage(timer, "witness+f_ldes+f_oracles"):
                w_dev = self.arp.encode_witness(witness)
                witness_polys = self.arp.calculate_witness_polys(w_dev)  # (R, T, L)
                del w_dev
                f_ldes = self._lde(witness_polys)  # (R, N_f, L), (R, N_f/W, L) under a mesh
                f_oracles, f_iop_roots = self._commit(f_ldes)
            with span("transcript"):
                for rb in f_iop_roots:
                    transcript.commit_bytes(rb)
            if ck is not None:
                self._save(ck, "stage1", {"witness_polys": self._to_file(witness_polys),
                                          "f_ldes": self._to_file(f_ldes, blocks)},
                           {"f_roots": [rb.hex() for rb in f_iop_roots],
                            "transcript": transcript.snapshot()})

        # 3+4. G composition + G LDE + oracle (src/prover/mod.rs:89-95)
        if "stage_g" in done:
            with timer.stage("g_composition+g_oracle(resumed)"):
                arrays, meta = load("stage_g")
                g_poly = from_numpy_limbs(arrays["g_poly"], self.device)
                g_lde_vals = self._rows(arrays["g_lde_vals"])
                (g_oracle,) = self._trees(g_lde_vals[None])
                g_iop_root = bytes.fromhex(meta["g_root"])
                self._check_roots([g_oracle], [g_iop_root], "stage_g")
        else:
            with self._stage(timer, "g_composition+g_oracle"):
                g_poly = self.ali.calculate_g(transcript, witness_polys)  # (D, L)
                g_lde_vals = self._lde(g_poly)
                (g_oracle,), (g_iop_root,) = self._commit(g_lde_vals[None])
            with span("transcript"):
                transcript.commit_bytes(g_iop_root)
            if ck is not None:
                self._save(ck, "stage_g", {"g_poly": self._to_file(g_poly),
                                           "g_lde_vals": self._to_file(g_lde_vals, blocks)},
                           {"g_root": g_iop_root.hex(), "transcript": transcript.snapshot()})

        # 5. DEEP (src/prover/mod.rs:99-106)
        if "deep" in done:
            with timer.stage("deep(resumed)"):
                arrays, meta = load("deep")
                h1_lde = self._rows(arrays["h1_lde"])
                h2_lde = self._rows(arrays["h2_lde"])
                f_at_z_m = [int(v) for v in meta["f_at_z_m"]]
        else:
            with self._stage(timer, "deep"):
                h1_lde, h2_lde, f_at_z_m, _g_at_z = self.ali.calculate_deep(
                    witness_polys, f_ldes, g_poly, g_lde_vals, transcript
                )
            if ck is not None:
                self._save(ck, "deep", {"h1_lde": self._to_file(h1_lde, blocks),
                                        "h2_lde": self._to_file(h2_lde, blocks)},
                           {"f_at_z_m": [str(v) for v in f_at_z_m],
                            "transcript": transcript.snapshot()})
        del witness_polys, g_poly

        # 6. FRI for h1 and h2 (src/prover/mod.rs:112-113); under a mesh on
        # the ranks' row blocks of them
        if "fri" in done:
            with timer.stage("fri_h1+h2(resumed)"):
                h1_proto, h2_proto = self._resume_fri(load("fri"), h1_lde, h2_lde)
        else:
            with self._stage(timer, "fri_h1+h2"):
                h1_proto, h2_proto = NaiveFriIop.proofs_from_ldes(
                    ops, [h1_lde, h2_lde], self.lde_factor, self.fri_final_degree_plus_one,
                    self.mesh)
            if ck is not None:
                self._save_fri(ck, (h1_proto, h2_proto), transcript)

        with span("transcript"):
            # 7. commit final roots + coefficients (src/prover/mod.rs:118-127)
            for proto in (h1_proto, h2_proto):
                transcript.commit_bytes(proto.get_final_root())
                for el in proto.get_final_coefficients():
                    transcript.commit_field_element(el)

            # 8. challenge indices (src/prover/mod.rs:129-139) on the LDE domains
            n_h1, n_h2 = (proto.l0_commitment.size for proto in (h1_proto, h2_proto))
            x_h1 = bytes_to_challenge_index(transcript.get_challenge_bytes(), n_h1,
                                            self.lde_factor)
            x_h2 = bytes_to_challenge_index(transcript.get_challenge_bytes(), n_h2,
                                            self.lde_factor)

        # 9+10. all query openings: both FRI chains' coset walks
        # (src/prover/mod.rs:142-143) and the f/g oracle openings
        # (:146-151), one gather (under a mesh one all_gather for every
        # sharded tree) and one fetch
        with self._stage(timer, "queries"):
            with span("query.plan"):
                h1_plan = NaiveFriIop.query_plan(h1_proto, h1_lde, x_h1)
                h2_plan = NaiveFriIop.query_plan(h2_proto, h2_lde, x_h2)
                x1 = torch.tensor([x_h1], dtype=torch.int64, device=self.device)
                x2 = torch.tensor([x_h2], dtype=torch.int64, device=self.device)
                chain_data = (h1_plan[2] + h2_plan[2]
                              + [(o, f_ldes[r]) for r, o in enumerate(f_oracles)]
                              + [(g_oracle, g_lde_vals)])
                idx_arrays = h1_plan[3] + h2_plan[3] + [x1] * len(f_oracles) + [x2]
                n1, n2 = len(h1_plan[2]), len(h2_plan[2])
                # chain_data holds the only references left, so that each
                # entry's values go once it is opened
                del h1_lde, h2_lde, f_ldes, g_lde_vals, f_oracles, g_oracle
                h1_plan[2].clear()
                h2_plan[2].clear()
                h1_proto.intermediate_values = h2_proto.intermediate_values = []
            with span("query.gather"):
                gathered = gather_chain_queries(chain_data, idx_arrays)
            with span("query.assemble"):
                fri_proof_h1 = NaiveFriIop.proof_from_gathered(
                    h1_proto, h1_plan[0], h1_plan[1], gathered[:n1], ops
                )
                fri_proof_h2 = NaiveFriIop.proof_from_gathered(
                    h2_proto, h2_plan[0], h2_plan[1], gathered[n1:n1 + n2], ops
                )
                f_queries = [_opening(ops, x_h1, v, s) for v, s in gathered[n1 + n2:-1]]
                g_query = _opening(ops, x_h2, *gathered[-1])

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

    def prove_batch(self, witnesses: List[Witness]) -> List[InstanceProof]:
        """Prove several witnesses of this instance at once (the port of
        hodor_tpu/prover.py prove_batch). Every stage runs once over a
        leading lane axis B, one lane per witness: each kernel launch and
        each host fetch covers all lanes, so the batch makes about as many
        launches as one prove(). Each returned proof is byte-identical to
        prove() of the same witness. Each witness takes either form of
        `prove`.

        B == 1, and an instance with no constraints or no boundary
        constraints, go to sequential prove() calls, as in the JAX
        package; so does a batch under a mesh, which distributes each proof
        and runs the proofs one after another (hodor_tpu/prover.py:466-484)."""
        props = self.arp.properties
        if (self.mesh is not None or len(witnesses) == 1 or not props.constraints
                or not props.boundary_constraints):
            return [self.prove(w) for w in witnesses]
        with self._recording() as timer:
            return self._prove_batch(timer, witnesses)

    def _prove_batch(self, timer: SpanRecorder, witnesses: List[Witness]) -> List[InstanceProof]:
        ops = self.ops
        field = self.field
        lanes = range(len(witnesses))
        transcripts = [Blake2sTranscript(field) for _ in witnesses]
        self.last_transcripts = transcripts

        # stage 1, batched: (B, R, T, L) -> (B, R, N_f, L), one batched
        # tree per register
        with timer.stage("batch:witness+f_ldes+f_oracles"):
            w_dev = torch.stack([self.arp.encode_witness(w) for w in witnesses])
            witness_polys = self.arp.calculate_witness_polys(w_dev)
            del w_dev
            f_ldes = self._lde(witness_polys)
            f_oracles, f_roots = self._commit(f_ldes.unbind(1))  # per register, per lane
        f_iop_roots = [[roots[b] for roots in f_roots] for b in lanes]
        with span("transcript"):
            for b, t in enumerate(transcripts):
                for rb in f_iop_roots[b]:
                    t.commit_bytes(rb)

        # G, batched (challenges drawn per proof in the reference order)
        with timer.stage("batch:g_composition+g_oracle"):
            g_poly = self.ali.calculate_g_batch(transcripts, witness_polys)  # (B, D, L)
            g_lde_vals = self._lde(g_poly)
            (g_oracle,), (g_iop_roots,) = self._commit([g_lde_vals])
        with span("transcript"):
            for t, rb in zip(transcripts, g_iop_roots):
                t.commit_bytes(rb)

        # DEEP, batched
        with timer.stage("batch:deep"):
            h1_lde, h2_lde, f_at_z_m, _g_at_z = self.ali.calculate_deep_batch(
                witness_polys, f_ldes, g_poly, g_lde_vals, transcripts)
        del witness_polys, g_poly

        # FRI, batched: one ladder per polynomial for all lanes
        with timer.stage("batch:fri_h1+h2"):
            (trees1, inter1, protos1), (trees2, inter2, protos2) = \
                NaiveFriIop.proofs_from_lde_batches(
                    ops, [h1_lde, h2_lde], self.lde_factor, self.fri_final_degree_plus_one)

        # per proof: final roots and coefficients, then the indices
        x_h1, x_h2 = [], []
        with span("transcript"):
            for b, t in enumerate(transcripts):
                for proto in (protos1[b], protos2[b]):
                    t.commit_bytes(proto.get_final_root())
                    for el in proto.get_final_coefficients():
                        t.commit_field_element(el)
                x_h1.append(bytes_to_challenge_index(
                    t.get_challenge_bytes(), h1_lde.shape[1], self.lde_factor))
                x_h2.append(bytes_to_challenge_index(
                    t.get_challenge_bytes(), h2_lde.shape[1], self.lde_factor))

        # every opening of every proof: one gather over the lanes, one
        # fetch; then the host assembly per proof
        with timer.stage("batch:queries"):
            with span("query.plan"):
                cosets1 = [NaiveFriIop.coset_walk(protos1[b], x_h1[b]) for b in lanes]
                cosets2 = [NaiveFriIop.coset_walk(protos2[b], x_h2[b]) for b in lanes]
                chain_data, idx_arrays = [], []
                for trees, values, cosets in ((trees1, [h1_lde] + inter1, cosets1),
                                              (trees2, [h2_lde] + inter2, cosets2)):
                    chain_data += list(zip(trees, values))
                    idx_arrays += [torch.tensor([walk[k] for walk in cosets], dtype=torch.int64,
                                                device=self.device) for k in range(len(trees))]
                x1 = torch.tensor(x_h1, dtype=torch.int64, device=self.device)[:, None]
                x2 = torch.tensor(x_h2, dtype=torch.int64, device=self.device)[:, None]
                chain_data += [(o, f_ldes[:, r]) for r, o in enumerate(f_oracles)]
                chain_data.append((g_oracle, g_lde_vals))
                idx_arrays += [x1] * len(f_oracles) + [x2]
            with span("query.gather"):
                gathered = gather_chain_queries(chain_data, idx_arrays)

            with span("query.assemble"):
                n1, n2 = len(trees1), len(trees2)
                proofs = []
                for b in lanes:
                    lane = [(v[b], s[:, b]) for v, s in gathered]
                    fri_proofs = [
                        NaiveFriIop.proof_from_gathered(
                            proto, [proto.l0_commitment] + proto.intermediate_commitments,
                            cosets[b], part, ops)
                        for proto, cosets, part in ((protos1[b], cosets1, lane[:n1]),
                                                    (protos2[b], cosets2, lane[n1:n1 + n2]))]
                    proofs.append(InstanceProof(
                        f_at_z_m=f_at_z_m[b],
                        f_iop_roots=f_iop_roots[b],
                        g_iop_root=g_iop_roots[b],
                        f_queries=[_opening(ops, x_h1[b], v, s) for v, s in lane[n1 + n2:-1]],
                        g_query=_opening(ops, x_h2[b], *lane[-1]),
                        h1_iop_roots=protos1[b].get_roots(),
                        h2_iop_roots=protos2[b].get_roots(),
                        fri_proof_h1=fri_proofs[0],
                        fri_proof_h2=fri_proofs[1],
                    ))
        return proofs
