"""Prove checkpoint/resume in the port (hodor_tpu_torch.checkpoint,
Prover.prove(..., checkpoint_dir=...)) on CPU tensors: a prove resumed
from any completed stage boundary gives the uninterrupted proof's bytes,
an orphan late stage is ignored, a saved root that the rebuilt tree does
not reproduce is refused, and a directory written by hodor_tpu's prover
resumes in the port to the same bytes (the same files, array names and
uint32 limbs). The instance is fib_f257: a JAX prove of it compiles in
under a minute on a fresh CPU worker."""

import json
import os
import shutil
from functools import lru_cache

import numpy as np
import pytest
import torch

import hodor_tpu.air as jair
from hodor_tpu.field import F257 as JF257
from hodor_tpu.prover import Prover as JProver
import hodor_tpu_torch.air as tair
from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
from hodor_tpu_torch.errors import SynthesisError
from hodor_tpu_torch.field import F257
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.transcript import Blake2sTranscript
from hodor_tpu_torch.verifier import Verifier

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _fib(air, field):
    fib = air.Fibonacci(field, final_b=5, at_step=3)
    tracer = air.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


@lru_cache(maxsize=None)
def _instance():
    witness, props = _fib(tair, F257)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    baseline = serialize_proof(prover.prove(witness), F257)
    with open(os.path.join(GOLDEN, "fib_f257.proof"), "rb") as f:
        assert baseline == f.read()
    return witness, props, prover, baseline


def _drop_after(ckdir, keep: int):
    """Delete every stage past the first `keep` (a prove that died in
    stage keep + 1)."""
    ck = ProveCheckpoint(ckdir)
    for s in STAGES[keep:]:
        for p in ck._paths(s):
            if os.path.exists(p):
                os.remove(p)


def test_checkpointed_prove_matches_plain(tmp_path):
    witness, props, prover, baseline = _instance()
    assert serialize_proof(prover.prove(witness, checkpoint_dir=str(tmp_path)), F257) == baseline
    ck = ProveCheckpoint(str(tmp_path))
    assert ck.completed_prefix() == list(STAGES)
    arrays, meta = ck.load("stage1")
    assert arrays["f_ldes"].dtype == np.uint32 and arrays["f_ldes"].shape[-1] == F257.n16
    assert len(meta["f_roots"]) == props.num_registers


@pytest.mark.parametrize("keep", [1, 2, 3, 4])
def test_resume_from_each_stage_boundary(tmp_path, keep):
    witness, props, prover, baseline = _instance()
    ckdir = str(tmp_path / f"ck{keep}")
    prover.prove(witness, checkpoint_dir=ckdir)
    _drop_after(ckdir, keep)
    assert ProveCheckpoint(ckdir).completed_prefix() == list(STAGES[:keep])
    resumed = prover.prove(witness, checkpoint_dir=ckdir)
    assert serialize_proof(resumed, F257) == baseline
    assert [r.name.endswith("(resumed)") for r in prover.last_timings.records[:4]] == \
        [i < keep for i in range(4)]
    assert Verifier(props, lde_factor=16).verify(resumed)
    # the resumed run saves the stages it computed again
    assert ProveCheckpoint(ckdir).completed_prefix() == list(STAGES)


def test_orphan_late_stage_is_ignored(tmp_path):
    """A later stage without its predecessors does not resume (the prefix
    rule of ProveCheckpoint.completed_prefix)."""
    witness, props, prover, baseline = _instance()
    ckdir = str(tmp_path / "orphan")
    prover.prove(witness, checkpoint_dir=ckdir)
    ck = ProveCheckpoint(ckdir)
    for p in ck._paths("stage1"):
        os.remove(p)
    assert ck.completed_prefix() == []
    assert serialize_proof(prover.prove(witness, checkpoint_dir=ckdir), F257) == baseline
    assert not any(r.name.endswith("(resumed)") for r in prover.last_timings.records)


def test_a_saved_root_the_values_do_not_give_is_refused(tmp_path):
    witness, props, prover, baseline = _instance()
    ckdir = str(tmp_path / "bad")
    prover.prove(witness, checkpoint_dir=ckdir)
    _drop_after(ckdir, 2)
    meta_path = os.path.join(ckdir, "stage_g.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["g_root"] = "00" * 32
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(SynthesisError, match="root"):
        prover.prove(witness, checkpoint_dir=ckdir)


def test_transcript_snapshot_restore_and_clone():
    t = Blake2sTranscript(F257)
    t.commit_bytes(b"root")
    t.get_challenge()
    t.commit_field_element(7)
    t.get_challenge_bytes()
    r = Blake2sTranscript.restore(F257, json.loads(json.dumps(t.snapshot())))
    c = t.clone()
    assert r.log == t.log == c.log
    assert r.get_challenge() == t.get_challenge() == c.get_challenge()


@lru_cache(maxsize=None)
def _jax_written(root):
    """A checkpoint directory written by hodor_tpu's prover of fib_f257."""
    witness, jprops = _fib(jair, JF257)
    ckdir = os.path.join(root, "jax")
    JProver(jprops.clone(), lde_factor=16, fri_final_degree_plus_one=1).prove(
        witness, checkpoint_dir=ckdir)
    return ckdir


@pytest.mark.parametrize("keep", [1, 2, 3, 4])
def test_hodor_tpu_checkpoint_resumes_in_the_port(tmp_path_factory, keep):
    witness, props, prover, baseline = _instance()
    ckdir = str(tmp_path_factory.mktemp(f"from_jax{keep}"))
    shutil.copytree(_jax_written(str(tmp_path_factory.getbasetemp())), ckdir,
                    dirs_exist_ok=True)
    _drop_after(ckdir, keep)
    assert ProveCheckpoint(ckdir).completed_prefix() == list(STAGES[:keep])
    assert serialize_proof(prover.prove(witness, checkpoint_dir=ckdir), F257) == baseline
    assert sum(r.name.endswith("(resumed)") for r in prover.last_timings.records) == keep
