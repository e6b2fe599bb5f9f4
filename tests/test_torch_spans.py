"""The prover's spans (profiling.SpanRecorder, Prover.last_timings) and the
benchmark's per-layer metrics that read them.

On the CPU: a hand-built tree (nesting, parent links, paths, self times,
one proof id), small proves whose records hold the five stage names and
the spans PERF.md lists, the spans as host operations of torch.profiler
that are no user annotations (those the profiler mirrors onto the
device's timeline), and the readers of stark_bench/metrics on made-up
inputs. Marked `cuda` (no JAX imported here, so on the card:
`python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q`): in
a profiled prove on the card no device event carries a span's name."""

import json

import pytest
import torch

from hodor_tpu_torch import profiling
from hodor_tpu_torch.field import F_STARK
from hodor_tpu_torch.models import VDF
from hodor_tpu_torch.profiling import Span, SpanRecorder, span
from hodor_tpu_torch.prover import Prover
from hodor_tpu_torch.verifier import Verifier
from stark_bench.spec import Spec

STAGES = ("witness+f_ldes+f_oracles", "g_composition+g_oracle", "deep", "fri_h1+h2", "queries")
# every span name a first prove on one device records (PERF.md §3)
SPANS = ("prover.init", "arp.route", "ali.tables", "encode_witness", "witness_polys", "lde",
         "merkle.commit", "transcript", "ali.g", "ali.terms", "ali.compose", "ali.boundary",
         "ali.interpolant", "ali.deep_quotients", "domain_points",
         "fri.fold", "fri.fetch", "fri.prototype", "query.plan",
         "query.gather", "query.assemble", "ops.tables")


def _vdf(c0=1, c1=2, rows=8):
    return VDF(F_STARK, c0, c1, rows - 1, witness="python").into_arp()


@pytest.fixture(scope="module")
def proved():
    """A Prover and the records of its first two proves (8 rows, lde 16)."""
    witness, props = _vdf()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    proofs, records = [], []
    for _ in range(2):
        proofs.append(prover.prove(witness))
        records.append(prover.last_timings)
    assert all(Verifier(props, lde_factor=16).verify(p) for p in proofs)
    return prover, records


def test_tree_nesting_parents_and_proof_id():
    rec = SpanRecorder("cpu")
    with rec.active():
        with rec.stage("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("b"):
                pass
        with span("d"):
            pass
    assert [(s.name, s.parent, s.stage) for s in rec.spans] == \
        [("a", -1, True), ("b", 0, False), ("c", 1, False), ("b", 0, False), ("d", -1, False)]
    assert rec.paths() == ["a", "a/b", "a/b/c", "a/b", "d"]
    assert [s.name for s in rec.records] == ["a"]
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    assert rec.spans[1].start_ns >= rec.spans[0].start_ns
    assert rec.spans[2].end_ns <= rec.spans[1].end_ns <= rec.spans[0].end_ns
    rec.proof = 7
    with rec.active(), span("e"):
        pass
    assert rec.spans[-1].name == "e" and json.loads(rec.to_json())["proof"] == 7


def test_self_times_report_and_json():
    """Self time: a path's seconds less its children's (exact ns)."""
    rec = SpanRecorder("cpu", proof=3)
    ms = 1_000_000
    rec.spans = [Span("a", 0, 10 * ms, -1, True), Span("b", 1 * ms, 4 * ms, 0),
                 Span("c", 2 * ms, 3 * ms, 1), Span("b", 5 * ms, 6 * ms, 0),
                 Span("t", 10 * ms, 12 * ms, -1)]
    assert rec.as_dict() == {"a": 0.01, "a/b": 0.004, "a/b/c": 0.001, "t": 0.002}
    own = rec.self_times()
    assert own["a"] == pytest.approx(0.006) and own["a/b"] == pytest.approx(0.003)
    assert own["a/b/c"] == pytest.approx(0.001) and own["t"] == pytest.approx(0.002)
    assert rec.total() == pytest.approx(0.012)
    lines = rec.report().splitlines()
    assert [line.split()[-1] for line in lines[1:-1]] == ["a", "b", "c", "t"]
    assert lines[2].split()[:3] == ["2", "4.00", "3.00"]
    doc = json.loads(rec.to_json())
    assert doc["proof"] == 3 and doc["stages"] == [["a", 0.01]] and len(doc["spans"]) == 5


def test_span_outside_a_prove_records_nothing_and_errors_close_spans():
    with span("nowhere"):
        pass
    rec = SpanRecorder("cpu")
    with pytest.raises(ValueError), rec.active(), span("outer"), span("inner"):
        raise ValueError("inside")
    assert [s.end_ns > 0 for s in rec.spans] == [True, True]
    with rec.active(), span("after"):
        pass
    assert rec.spans[-1].parent == -1
    assert profiling._current.get() is None


def test_prove_keeps_the_stage_names(proved):
    _, (first, _) = proved
    stages = first.as_dict()
    assert [r.name for r in first.records] == list(STAGES)
    for name in STAGES:
        assert name in stages and stages[name] > 0


@pytest.mark.parametrize("name", SPANS)
def test_first_prove_records_each_span(proved, name):
    _, (first, _) = proved
    assert name in {s.name for s in first.spans}


def test_ladder_records_no_challenge_span(proved):
    """The fold draws each round's challenge from the last root itself: no
    prove records a `fri.challenge` span, and the folds are spanned."""
    for rec in proved[1]:
        names = {s.name for s in rec.spans}
        assert "fri.challenge" not in names and "fri.fold" in names


def test_no_child_ends_in_a_stage_name(proved):
    _, records = proved
    stage_names = STAGES + tuple(f"batch:{s}" for s in STAGES)
    for rec in records:
        for path in rec.as_dict():
            if "/" in path:
                assert not path.endswith(stage_names), path


def test_records_hold_what_the_prover_did_since_its_last_prove(proved):
    """The construction's spans go into the first prove's record alone;
    each prove's record has its own id, which all its spans share."""
    prover, (first, second) = proved
    assert first.spans[0].name == "prover.init" and first.spans[0].parent == -1
    assert "prover.init" not in second.as_dict()
    assert first.proof >= 0 and second.proof >= 0 and first.proof != second.proof
    assert prover.last_timings is second


def test_batch_lanes_share_one_proof_id():
    w0, props = _vdf(1, 2)
    w1, _ = _vdf(1, 2)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cpu")
    proofs = prover.prove_batch([w0, w1])
    assert len(proofs) == 2
    rec = prover.last_timings
    assert [r.name for r in rec.records] == [f"batch:{s}" for s in STAGES]
    assert rec.proof >= 0
    counts = [p.rsplit("/", 1)[-1] for p in rec.paths()]
    assert counts.count("encode_witness") == 2
    assert "batch:queries/query.assemble" in rec.as_dict()


def test_spans_are_host_operations_and_no_user_annotations(proved):
    """Each span name of a prove, opened under torch.profiler (a whole
    profiled prove takes minutes on the CPU), is a host operation of the
    profiler and no user annotation."""
    from torch.profiler import ProfilerActivity, profile

    _, (first, _) = proved
    names = {s.name for s in first.spans}
    rec = SpanRecorder("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, rec.active():
        for name in sorted(names):
            with span(name):
                torch.ones(2).add_(1)
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(names)
    assert all(not e.is_user_annotation for e in events)


# ---------------------------------------------------------------- readers

def _ctx(stages, latencies=(0.5, 0.5), lanes=1):
    return {"stages": stages, "proofs": 2, "latencies": list(latencies),
            "traffic": {"lanes": lanes}, "trace": None}


SPANNED = {"prover.init": 0.04, "prover.init/ali.tables": 0.03,
           "witness+f_ldes+f_oracles": 0.2, "witness+f_ldes+f_oracles/encode_witness": 0.006,
           "transcript": 0.001, "g_composition+g_oracle": 0.3,
           "g_composition+g_oracle/ali.g/transcript": 0.0005,
           "g_composition+g_oracle/ali.g/ali.terms": 0.08,
           "g_composition+g_oracle/ali.g/ali.compose": 0.05, "deep": 0.1,
           "deep/ali.deep_quotients/transcript": 0.0005, "fri_h1+h2": 0.2, "queries": 0.1,
           "queries/query.assemble": 0.004}


@pytest.mark.parametrize("metric, stages, expected", [
    ("prover.init_s", SPANNED, 0.02),
    ("protocol.encode_witness_s", SPANNED, 0.003),
    ("protocol.transcript_s", SPANNED, 0.001),
    ("protocol.query_assembly_s", SPANNED, 0.002),
    ("prover.unspanned_share", SPANNED, 5.9),
    ("protocol.query_assembly_s", {"batch:queries/query.assemble": 0.004}, 0.002),
    ("protocol.encode_witness_s", {"batch:witness+f_ldes+f_oracles/encode_witness": 0.003,
                                   "witness+f_ldes+f_oracles (resumed)/encode_witness": 0.001},
     0.002),
    ("ali.terms_s", SPANNED, 0.04),
    ("ali.compose_s", SPANNED, 0.025),
    ("ali.terms_s", {"batch:g_composition+g_oracle/ali.g/ali.terms": 0.02}, 0.01),
    ("ali.compose_s", {"batch:g_composition+g_oracle/ali.g/ali.compose": 0.02}, 0.01),
    ("ali.terms_s", {"deep": 0.1}, None),
    ("ali.compose_s", {"deep": 0.1}, None),
    ("prover.init_s", {"deep": 0.1}, None),
    ("protocol.encode_witness_s", {"deep": 0.1}, None),
    ("protocol.transcript_s", {"deep": 0.1}, None),
    ("protocol.query_assembly_s", {"deep": 0.1}, None),
    ("prover.unspanned_share", {}, None),
])
def test_span_readers(metric, stages, expected):
    value = Spec().reader(metric)(_ctx(stages))
    assert value == (None if expected is None else pytest.approx(expected))


def test_unspanned_share_counts_a_batch_call_once():
    """A batch call's latency is listed once a lane; its spans once."""
    read = Spec().reader("prover.unspanned_share")
    assert read(_ctx({"deep": 0.9}, latencies=(1.0, 1.0), lanes=2)) == pytest.approx(10.0)


# ---------------------------------------------------------------- card

@pytest.mark.cuda
def test_no_device_event_carries_a_span_name():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hodor_tpu_torch.field import kernels

    kernels.build_kernels()
    witness, props = _vdf(rows=1 << 10)
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cuda")
    prover.prove(witness)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        proof = prover.prove(witness)
        torch.cuda.synchronize()
    assert Verifier(props, lde_factor=16).verify(proof)
    names = {s.name for s in prover.last_timings.spans}
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names <= host
    assert device and not names & set(device)
