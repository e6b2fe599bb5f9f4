"""The port's memory-bounded forms on CPU tensors (the counterpart of
tests/test_memory.py): trees that keep only their top levels and open by
hashing the committed rows under their indices again (merkle/tree.py
TREE_DROP_MIN), leaves hashed in row
chunks (merkle/blake2s.py HASH_CHUNK), LDEs one coset at a time (ntt
LDE_SEQUENTIAL_MIN), and DEEP's domain points not kept and its rows taken
in chunks (ali/instance.py XS_KEEP_MAX). Each form is picked by size; a
test forces it by setting its constant low. Under each form alone
vdf_fstark_t32 (which engages every form), and under all of them the
three goldens of tests/golden/ (hodor_tpu's bytes), come out byte for
byte and verify; the forms' pieces equal the plain ones bit for bit
(tolerance 0); with every form forced a batch, a resume and the warm
prove's fetches are as without them; and with or without the forms the
query stage lets the f-LDEs go before it ends."""

import os
import sys
import weakref
from functools import lru_cache

import pytest
import torch

import hodor_tpu_torch.ali.instance as ali_instance
import hodor_tpu_torch.fri.fri as fri_module
import hodor_tpu_torch.merkle.blake2s as blake2s_module
import hodor_tpu_torch.merkle.tree as tree_module
import hodor_tpu_torch.ntt as ntt_module
from hodor_tpu_torch import air, profiling
from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps, limbs
from hodor_tpu_torch.merkle.blake2s import hash_leaf_limbs, hash_leaves, limbs_to_leaf_words
from hodor_tpu_torch.merkle.tree import MerkleTree
from hodor_tpu_torch.models import VDF, CubicVDF
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools.dryrun import run_ranks
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# each form's constant and the value that forces it on a trace of T rows
# (the LDEs at lde 16 have 16 T rows and more): the thresholds at 1, the
# chunks at 8 T rows, so that every LDE-sized array is taken in 2 to 4
# chunks
FORMS = {
    "dropped_trees": [(tree_module, "TREE_DROP_MIN", 0)],
    "chunked_leaves": [(blake2s_module, "HASH_CHUNK", 8)],
    "lde_by_coset": [(ntt_module, "LDE_SEQUENTIAL_MIN", 0)],
    "deep_tables_not_kept": [(ali_instance, "XS_KEEP_MAX", 8)],
}
FORMS["all"] = [patch for patches in FORMS.values() for patch in patches]
# the form_counts entry each form engages
COUNTED = {"dropped_trees": "trees_dropped", "chunked_leaves": "leaves_chunked",
           "lde_by_coset": "ldes_by_coset", "deep_tables_not_kept": "deep_tables_not_kept"}


def _force(monkeypatch, form, rows):
    """Force `form` on a trace of `rows` rows: a constant listed at 0 set
    to 1, one listed at k set to k * rows."""
    for module, name, k in FORMS[form]:
        monkeypatch.setattr(module, name, k * rows if k else 1)


def _fib():
    fib = air.Fibonacci(F257, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


GOLDENS = {
    "fib_f257": (_fib, F257),
    "vdf_fstark_t32": (lambda: VDF(F_STARK, 1, 2, 31).into_arp(), F_STARK),
    "cubic_vdf_fstark_t32": (lambda: CubicVDF(F_STARK, 1, 1, 31).into_arp(), F_STARK),
}


def _prover(props):
    return Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")


@lru_cache(maxsize=None)
def _golden_prover(name):
    """(witness, props, field, prover) of a golden, the prover set up once
    for every form: the forms are read when a prove runs."""
    into_arp, field = GOLDENS[name]
    witness, props = into_arp()
    return witness, props, field, _prover(props)


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.proof"), "rb") as f:
        return f.read()


# each form alone on the golden that engages every form, all of them
# together on every golden
FORM_CASES = ([(form, "vdf_fstark_t32") for form in FORMS if form != "all"]
              + [("all", name) for name in GOLDENS])


@pytest.mark.parametrize("form,name", FORM_CASES, ids=[f"{f}-{n}" for f, n in FORM_CASES])
def test_goldens_under_each_form(monkeypatch, form, name):
    witness, props, field, prover = _golden_prover(name)
    _force(monkeypatch, form, props.num_rows)
    profiling.reset_form_counts()
    proof = prover.prove(witness)
    engaged = {COUNTED[f] for f in COUNTED if form in (f, "all")}
    assert {k for k, v in profiling.form_counts.items() if v} == engaged
    assert serialize_proof(proof, field) == _golden(name)
    assert Verifier(props, lde_factor=16).verify(proof)


def _leaves(field, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return LimbOps(field, "cpu").encode(
        [int(v) % field.p for v in torch.randint(0, 1 << 62, shape, generator=gen).flatten()]
    ).reshape(shape + (field.n16,))


@pytest.mark.parametrize("lanes", [None, 3])
def test_dropped_tree_opens_like_the_kept_tree(monkeypatch, lanes):
    shape = (256,) if lanes is None else (lanes, 256)
    values = _leaves(F_STARK, shape, 7)
    kept = MerkleTree.create(values, F_STARK)
    monkeypatch.setattr(tree_module, "TREE_DROP_MIN", 256)
    dropped = MerkleTree.create(values, F_STARK)
    assert dropped.dropped and not kept.dropped
    # 256 leaves: k = 4, the levels of 16 digests up to the root kept
    assert dropped.leaf_hashes is None and dropped.lost == 4
    assert [level.shape[-2] for level in dropped.levels] == [16, 8, 4, 2, 1]
    assert torch.equal(dropped.root_digest(), kept.root_digest())
    assert dropped.get_roots() == kept.get_roots() and dropped.size == kept.size == 256
    idx = torch.arange(256)
    if lanes is not None:  # every lane opens every index, each lane in its own order
        idx = torch.stack([torch.roll(idx, 17 * b) for b in range(lanes)])
    want = kept.path_digests(idx)
    assert torch.equal(dropped.path_digests(idx, values), want)
    with pytest.raises(ValueError, match="committed values"):
        dropped.path_digests(idx)
    if lanes is not None:
        assert dropped.lane(1).get_path(5, values[1]) == kept.lane(1).get_path(5)
    kept.drop()
    assert kept.dropped and torch.equal(kept.path_digests(idx, values), want)


@pytest.mark.parametrize("lanes", [None, 2])
@pytest.mark.parametrize("log_n", range(1, 13))
def test_dropped_tree_hashes_only_the_subtrees_under_its_indices(monkeypatch, log_n, lanes):
    """At every parity of log2 N, k = ⌊log2 N / 2⌋ = 0 included: a dropped
    tree keeps fewer than 2^(⌈log2 N / 2⌉ + 1) digests a lane, opens the
    first and last leaf and a FRI pair (2i, 2i + 1) as the kept tree does,
    by its lanes and lane by lane, before and after drop(), and hashes
    Q 2^k leaves a lane again, not N."""
    n, k = 1 << log_n, log_n // 2
    shape = (n,) if lanes is None else (lanes, n)
    values = _leaves(F_STARK, shape, log_n)
    kept = MerkleTree.create(values, F_STARK)
    monkeypatch.setattr(tree_module, "TREE_DROP_MIN", n)
    dropped = MerkleTree.create(values, F_STARK)
    assert dropped.lost == k and dropped.dropped == (k > 0)
    assert sum(level.shape[-2] for level in dropped.levels) < 1 << (-(-log_n // 2) + 1)
    assert dropped.get_roots() == kept.get_roots()
    pair = 2 * (n // 3 // 2)
    idx = torch.tensor([0, n - 1, pair, pair + 1])
    if lanes is not None:
        idx = torch.stack([idx, idx.flip(0)])
    want = kept.path_digests(idx)
    assert want.shape[0] == log_n
    profiling.reset_reopen_counts()
    assert torch.equal(dropped.path_digests(idx, values), want)
    # k = 0 keeps every level: nothing to hash again
    assert profiling.reopen_counts == {"openings": int(k > 0),
                                       "leaves_hashed": idx.numel() << k if k else 0}
    if lanes is not None:
        for b in range(lanes):
            lane = dropped.lane(b)
            assert lane.lost == k and lane.lanes is None
            assert torch.equal(lane.path_digests(idx[b], values[b]), want[:, b])
    kept.drop()
    assert [level.shape for level in kept.levels] == [level.shape for level in dropped.levels]
    assert torch.equal(kept.path_digests(idx, values), want)


@pytest.mark.parametrize("coset", [False, True])
@pytest.mark.parametrize("factor", [2, 4, 8, 16])
@pytest.mark.parametrize("field", [F_STARK, F_BLS], ids=lambda f: f.name)
def test_lde_by_coset_equals_the_batched_lde(monkeypatch, field, factor, coset):
    ops = LimbOps(field, "cpu")
    coeffs = _leaves(field, (2, 3, 8), factor)  # lanes, registers, T
    batched = ntt_module.lde(ops, coeffs, factor, coset)
    one = ntt_module.lde(ops, coeffs[0, 1], factor, coset)
    monkeypatch.setattr(ntt_module, "LDE_SEQUENTIAL_MIN", 1)
    profiling.reset_form_counts()
    assert torch.equal(ntt_module.lde(ops, coeffs, factor, coset), batched)
    assert torch.equal(ntt_module.lde(ops, coeffs[0, 1], factor, coset), one)
    assert profiling.form_counts["ldes_by_coset"] == 2


@pytest.mark.parametrize("field,lanes", [(F_STARK, None), (F_STARK, 2), (F_P63, 3)],
                         ids=["F_STARK", "F_STARK-lanes", "F_P63-lanes"])
def test_chunked_leaf_hashes_equal_the_whole(monkeypatch, field, lanes):
    shape = (200,) if lanes is None else (lanes, 200)
    values = _leaves(field, shape, 3)
    words = limbs_to_leaf_words(values)
    want = hash_leaves(words)
    assert torch.equal(hash_leaf_limbs(values), want)
    monkeypatch.setattr(blake2s_module, "HASH_CHUNK", 48)  # 48, ..., 48, 8 rows
    profiling.reset_form_counts()
    assert torch.equal(hash_leaf_limbs(values), want)
    assert profiling.form_counts["leaves_chunked"] == 1
    for r0 in range(0, 200, 48):
        assert torch.equal(limbs_to_leaf_words(values[..., r0:r0 + 48, :]),
                           words[..., r0:r0 + 48, :])


def test_prove_batch_with_every_form_equals_sequential_proves(monkeypatch):
    witness, props = VDF(F_STARK, 1, 2, 3).into_arp()
    _force(monkeypatch, "all", props.num_rows)
    other, _ = VDF(F_STARK, 3, 5, 3).into_arp()  # another witness under the same instance
    prover = _prover(props)
    profiling.reset_form_counts()
    proofs = prover.prove_batch([witness, other])
    assert profiling.form_counts["trees_dropped"] > 0
    batch = [serialize_proof(p, F_STARK) for p in proofs]
    assert batch == [serialize_proof(prover.prove(w), F_STARK) for w in (witness, other)]
    assert batch[0] != batch[1]
    assert Verifier(props, lde_factor=16).verify(proofs[0])


def test_resume_after_fri_with_every_form(monkeypatch, tmp_path):
    witness, props = _fib()
    _force(monkeypatch, "all", props.num_rows)
    prover = _prover(props)
    first = serialize_proof(prover.prove(witness, checkpoint_dir=str(tmp_path)), F257)
    ck = ProveCheckpoint(str(tmp_path))
    assert ck.completed_prefix() == list(STAGES)
    profiling.reset_form_counts()
    resumed = serialize_proof(_prover(props).prove(witness, checkpoint_dir=str(tmp_path)), F257)
    assert first == resumed == _golden("fib_f257")
    assert profiling.form_counts["trees_dropped"] > 0  # the resumed trees dropped by size


def test_warm_prove_fetch_count_with_every_form(monkeypatch):
    """Five fetch_together calls a warm prove, as tests/test_torch_transfers.py
    counts them without the forms: the one-at-a-time openings still end
    in one fetch."""
    witness, props = _fib()
    _force(monkeypatch, "all", props.num_rows)
    prover = _prover(props)
    prover.prove(witness)
    real = limbs.fetch_together
    calls = []

    def counting(tensors):
        calls.append(sys._getframe(1).f_code.co_name)
        return real(tensors)

    for name, module in list(sys.modules.items()):
        if name.startswith("hodor_tpu_torch") and getattr(module, "fetch_together", None) is real:
            monkeypatch.setattr(module, "fetch_together", counting)
    assert serialize_proof(prover.prove(witness), F257) == _golden("fib_f257")
    assert calls == ["fetch_roots", "fetch_roots", "_deep", "run_ladders",
                     "gather_chain_queries"]


@pytest.mark.parametrize("forced", [False, True], ids=["plain", "all-forms"])
def test_f_ldes_are_freed_before_the_query_stage_ends(monkeypatch, forced):
    """With or without the forms, the f-LDEs (the prover's first LDE) and
    h1 (DEEP's first output) are freed, with no garbage collection, by the
    time the query stage opens its last entry, the G oracle: every holder
    let go of them."""
    witness, props = VDF(F_STARK, 1, 2, 3).into_arp()
    if forced:
        _force(monkeypatch, "all", props.num_rows)
    prover = _prover(props)
    refs = {}
    plain_lde, plain_deep, plain_open = Prover._lde, prover.ali.calculate_deep, fri_module.open_entry

    def lde(self, coeffs):
        out = plain_lde(self, coeffs)
        refs.setdefault("f_ldes", weakref.ref(out))
        return out

    def calculate_deep(*args):
        out = plain_deep(*args)
        refs["h1"] = weakref.ref(out[0])
        return out

    alive = []  # per opened entry, the watched arrays still alive

    def open_entry(tree, values, idx):
        alive.append({k for k, r in refs.items() if r() is not None})
        return plain_open(tree, values, idx)

    monkeypatch.setattr(Prover, "_lde", lde)
    monkeypatch.setattr(prover.ali, "calculate_deep", calculate_deep)
    monkeypatch.setattr(fri_module, "open_entry", open_entry)
    proof = prover.prove(witness)
    assert set(refs) == {"f_ldes", "h1"}
    assert alive[0] == {"f_ldes", "h1"}  # h1's first layer, opened first
    assert alive[-1] == set()  # the G oracle, opened last
    assert Verifier(props, lde_factor=16).verify(proof)


def _rank_forced_proves(mesh, device):
    """One rank of a mesh: fib_f257 and vdf_fstark_t32 with every form's
    constant set as _force sets it (spawned ranks: set on the modules);
    returns per golden (proof bytes, form counts, reopen counts, the rows
    of the blocks whose dropped trees were opened)."""
    out = {}
    reopen = tree_module.subtree_path_digests
    rows = []

    def counted(leaf_limbs, idx, k):
        rows.append(leaf_limbs.shape[-2])
        return reopen(leaf_limbs, idx, k)

    tree_module.subtree_path_digests = counted
    for name in ("fib_f257", "vdf_fstark_t32"):
        into_arp, field = GOLDENS[name]
        witness, props = into_arp()
        for module, attr, k in FORMS["all"]:
            setattr(module, attr, k * props.num_rows if k else 1)
        profiling.reset_form_counts()
        profiling.reset_reopen_counts()
        rows.clear()
        proof = Prover(props.clone(), 16, 1, device=device, mesh=mesh).prove(witness)
        out[name] = (serialize_proof(proof, field), dict(profiling.form_counts),
                     dict(profiling.reopen_counts), sum(rows))
    return out


def test_goldens_under_a_mesh_with_the_forms_forced(tmp_path):
    """At W = 2 the ranks' trees drop and their leaves and DEEP rows go in
    chunks by size (the sharded openings hash the subtrees of a dropped
    block under its indices again, fewer leaves than its rows). Every rank
    gives the goldens' bytes."""
    ranks = run_ranks(_rank_forced_proves, 2, device="cpu", backend="gloo",
                      init_method=f"file://{tmp_path / 'store'}", timeout=300)
    for r, out in enumerate(ranks):
        for name, (proof, counts, reopened, rows) in out.items():
            assert proof == _golden(name), f"rank {r} {name}"
            assert counts["trees_dropped"], (r, counts)
            assert reopened["openings"] > 0 and 0 < reopened["leaves_hashed"] < rows, \
                (r, name, reopened, rows)
        # a rank's blocks of vdf_fstark_t32 are long enough to be chunked
        counts = out["vdf_fstark_t32"][1]
        assert counts["leaves_chunked"] and counts["deep_tables_not_kept"], (r, counts)
