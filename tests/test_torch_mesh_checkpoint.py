"""Prove checkpoint/resume under a mesh (Prover(mesh=...).prove(...,
checkpoint_dir=...); the JAX package's prove takes a checkpoint directory
under a mesh too) on gloo ranks spawned on the CPU: at W = 2 and 4 a
checkpointed prove of vdf_fstark_t32 and a resume after each of its four
stages, every rank's proof byte-equal to tests/golden/vdf_fstark_t32; a
directory written at W = 2 resumed at W = 4 and on one device; one
written by hodor_tpu's prover (fib_f257) resumed at W = 2, byte-equal to
tests/golden/fib_f257; a tampered saved root (stage G's, and a sharded
FRI layer's) refused on every rank, within the spawn's timeout.

The spawns run at once where they can: W = 2, then W = 4 (which resumes
W = 2's directory), beside hodor_tpu's prove in this process and then the
two ranks that resume its directory. The ranks import this module, so JAX
is imported only in this process."""

import concurrent.futures
import json
import os
import shutil

import numpy as np
import pytest
import torch.distributed as dist

from hodor_tpu_torch import air
from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
from hodor_tpu_torch.errors import SynthesisError
from hodor_tpu_torch.field import F257, F_STARK
from hodor_tpu_torch.models import VDF
from hodor_tpu_torch.proof_io import serialize_proof
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.tools.dryrun import run_ranks

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
WORLDS = [2, 4]


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.proof"), "rb") as f:
        return f.read()


def _fibonacci(air_module, field):
    """tests/test_fri.py:83-97: Fibonacci over F257, 4 rows."""
    fib = air_module.Fibonacci(field, final_b=5, at_step=3)
    tracer = air_module.TestTraceSystem(field)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    return tracer.into_arp()


def _drop_after(ckdir, keep: int):
    """Delete every stage past the first `keep` (a prove that died in
    stage keep + 1)."""
    ck = ProveCheckpoint(ckdir)
    for stage in STAGES[keep:]:
        for path in ck._paths(stage):
            if os.path.exists(path):
                os.remove(path)


def _resumes(mesh, prover, witness, field, source, dest, keeps):
    """Every rank resumes copies of the directory `source` cut after each
    stage count in `keeps` (rank 0 makes them). Returns per stage cut
    after (proof bytes, the stages the prove resumed)."""
    if mesh.get_local_rank() == 0:
        for keep in keeps:
            shutil.copytree(source, f"{dest}_{keep}")
            _drop_after(f"{dest}_{keep}", keep)
    dist.barrier(group=mesh.get_group())
    out = {}
    for keep in keeps:
        blob = serialize_proof(prover.prove(witness, checkpoint_dir=f"{dest}_{keep}"), field)
        out[STAGES[keep - 1]] = (
            blob, sum(r.name.endswith("(resumed)") for r in prover.last_timings.records))
    return out


def _tampered(mesh, prover, witness, full, dest):
    """Resumes of two copies of `full`, one with stage G's saved root and
    one with the FRI stage's second h1 root (a sharded layer's) zeroed
    (rank 0 edits them). Returns per copy the error this rank raised."""
    if mesh.get_local_rank() == 0:
        shutil.copytree(full, f"{dest}_g")
        _drop_after(f"{dest}_g", 2)
        with open(os.path.join(f"{dest}_g", "stage_g.json")) as f:
            meta = json.load(f)
        meta["g_root"] = "00" * 32
        with open(os.path.join(f"{dest}_g", "stage_g.json"), "w") as f:
            json.dump(meta, f)
        shutil.copytree(full, f"{dest}_fri")
        arrays, _ = ProveCheckpoint(f"{dest}_fri").load("fri")
        arrays["h1_roots"][1] = 0
        np.savez(os.path.join(f"{dest}_fri", "fri.npz"), **arrays)
    dist.barrier(group=mesh.get_group())
    out = {}
    for tag in ("g", "fri"):
        try:
            prover.prove(witness, checkpoint_dir=f"{dest}_{tag}")
            out[tag] = None
        except SynthesisError as e:
            out[tag] = str(e)
    return out


def _rank_checkpoints(mesh, device, root):
    """One rank on vdf_fstark_t32: a checkpointed prove into root/w<W>,
    resumes after each of its stages, the tampered copies; at W = 4 also a
    resume of every stage of root/w2, written at W = 2."""
    w = mesh.size()
    witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
    prover = Prover(props.clone(), 16, 1, device=device, mesh=mesh)
    full = os.path.join(root, f"w{w}")
    all_stages = range(1, len(STAGES) + 1)
    out = {"full": serialize_proof(prover.prove(witness, checkpoint_dir=full), F_STARK),
           "saved": ProveCheckpoint(full).completed_prefix(),
           "resumed": _resumes(mesh, prover, witness, F_STARK, full,
                               os.path.join(root, f"w{w}_keep"), all_stages),
           "tampered": _tampered(mesh, prover, witness, full, os.path.join(root, f"w{w}_bad"))}
    if w == 4:
        out["from_w2"] = _resumes(mesh, prover, witness, F_STARK, os.path.join(root, "w2"),
                                  os.path.join(root, "w2_at_w4"), [len(STAGES)])
    return out


def _rank_resumes_jax_directory(mesh, device, source, dest):
    """One rank: resumes of fib_f257 after each stage of `source`, written
    by hodor_tpu's prover."""
    witness, props = _fibonacci(air, F257)
    prover = Prover(props.clone(), 16, 1, device=device, mesh=mesh)
    return _resumes(mesh, prover, witness, F257, source, dest, range(1, len(STAGES) + 1))


def _jax_written(ckdir):
    """hodor_tpu's prove of fib_f257 with a checkpoint directory."""
    import hodor_tpu.air as jair
    from hodor_tpu.field import F257 as JF257
    from hodor_tpu.prover import Prover as JProver

    witness, jprops = _fibonacci(jair, JF257)
    JProver(jprops.clone(), lde_factor=16, fri_final_degree_plus_one=1).prove(
        witness, checkpoint_dir=ckdir)
    return ckdir


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """2, 4 and "jax" -> the ranks' results; "root" -> the directory of
    the checkpoints."""
    root = tmp_path_factory.mktemp("checkpoints")

    def spawn(fn, w, *args):
        rdv = tmp_path_factory.mktemp(f"rendezvous_w{w}") / "store"
        return run_ranks(fn, w, args, device="cpu", backend="gloo", init_method=f"file://{rdv}",
                         timeout=240)

    def ladder():
        got = {2: spawn(_rank_checkpoints, 2, str(root))}
        got[4] = spawn(_rank_checkpoints, 4, str(root))
        return got

    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        meshes = pool.submit(ladder)
        jax_dir = _jax_written(str(root / "jax"))
        jax_ranks = pool.submit(spawn, _rank_resumes_jax_directory, 2, jax_dir,
                                str(root / "jax_at_w2"))
        out = dict(meshes.result(), jax=jax_ranks.result(), root=root)
    return out


def _assert_resumes(resumes, want, where):
    for stage, (blob, resumed) in resumes.items():
        assert blob == want, f"{where}: the resume after {stage}"
        assert resumed == STAGES.index(stage) + 1, f"{where}: stages resumed after {stage}"


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("w", WORLDS)
def test_checkpointed_mesh_prove_and_resume_after_each_stage(spawned, w, stage):
    """The checkpointed prove saves all four stages and gives the golden;
    a resume after `stage` gives it on every rank."""
    data = _golden("vdf_fstark_t32")
    for r, ranks in enumerate(spawned[w]):
        assert ranks["full"] == data and ranks["saved"] == list(STAGES), f"rank {r}"
        _assert_resumes({stage: ranks["resumed"][stage]}, data, f"rank {r}")


def test_directory_written_at_w2_resumes_at_w4(spawned):
    data = _golden("vdf_fstark_t32")
    for r, ranks in enumerate(spawned[4]):
        _assert_resumes(ranks["from_w2"], data, f"rank {r}")


def test_directory_written_at_w2_resumes_on_one_device(spawned):
    """Resumed after DEEP: the FRI stage runs on one device from the
    mesh's h1 and h2."""
    witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
    prover = Prover(props.clone(), 16, 1, device="cpu")
    ckdir = str(spawned["root"] / "w2_on_one_device")
    shutil.copytree(str(spawned["root"] / "w2"), ckdir)
    _drop_after(ckdir, 3)
    assert serialize_proof(prover.prove(witness, checkpoint_dir=ckdir), F_STARK) == \
        _golden("vdf_fstark_t32")
    assert [r.name.endswith("(resumed)") for r in prover.last_timings.records[:4]] == \
        [True, True, True, False]


def test_hodor_tpu_directory_resumes_at_w2(spawned):
    data = _golden("fib_f257")
    for r, resumes in enumerate(spawned["jax"]):
        assert sorted(resumes) == sorted(STAGES)
        _assert_resumes(resumes, data, f"rank {r}")


@pytest.mark.parametrize("w", WORLDS)
def test_tampered_saved_root_is_refused_on_every_rank(spawned, w):
    for r, ranks in enumerate(spawned[w]):
        for tag, stage in (("g", "stage_g"), ("fri", "fri")):
            err = ranks["tampered"][tag]
            assert err is not None and f"checkpoint stage {stage!r}" in err, f"rank {r}: {tag}"
