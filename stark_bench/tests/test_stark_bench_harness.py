"""The harness on the CPU: every part found by name, the contract's last
line, the metric arithmetic on recorded inputs, faults of the timed path
judged not correct, parts added as files alone, no JAX in a run."""

import json
import os
import re
import statistics
import subprocess
import sys
import types

import pytest
import torch

from stark_bench import roofline, run as harness, trace, traffic
from stark_bench.program import Program
from stark_bench.spec import HERE, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    spec = Spec()
    bench = spec.bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["stark_bench"] and 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert c["reduced"] == [] and c["file"].startswith("stark_bench/")


def test_every_part_loads_by_name():
    spec = Spec()
    for w in spec.bench["workloads"]:
        config, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        air = spec.air(w["config"])
        assert config["registers"] == air.REGISTERS
        assert config["max_constraint_degree"] == max(
            sum(pw for _r, _s, pw in f) for terms in air.CONSTRAINTS for _c, f in terms)
        assert {"log_rows", "pool", "lanes", "trace_calls"} <= set(mix)
        for trace_run in (False, True):
            for m in spec.metrics(w["name"], trace_run):
                assert callable(spec.reader(m["name"]))


def test_metric_arithmetic_on_recorded_inputs():
    spec = Spec()
    lat = [0.40 + 0.01 * i for i in range(20)]
    tr = {"busy_s": 0.75, "window_s": 1.5, "proofs": 3,
          "groups": {"ntt_level (mma body)": 0.3, "wide_reduce": 0.0, "blake2s": 0.09}}
    ctx = {"setup_s": 12.5, "window_s": 10.0, "proofs": 24, "calls": 24, "latencies": lat,
           "peak_bytes": 3 * 2**30, "stages": {"fri_h1+h2": 2.4, "witness+f_ldes+f_oracles": 1.2,
                                               "queries": 0.5},
           "launches": {"mont_mul": 48, "ntt_level": 24}, "forms": {"trees_dropped": 48},
           "trace": tr, "config": {"fri_final_degree_plus_one": 1}, "shape": (2, 2, 20, 16)}
    read = lambda name: spec.reader(name)(ctx)
    assert read("proofs_per_s") == 2.4
    assert read("prove_p90_s") == pytest.approx(statistics.quantiles(lat, n=10,
                                                                     method="inclusive")[8])
    assert read("peak_device_gib") == 3.0 and read("setup_s") == 12.5
    assert read("prover.fri_stage_s") == pytest.approx(0.1)
    assert read("prover.ldes_stage_s") == pytest.approx(0.05)
    assert read("launch_path.launches_per_proof") == 3.0
    assert read("forms.engaged_per_proof") == 2.0
    # 0.25 s busy a proof against 10 s / 24 proofs of untraced window
    assert read("device.idle_share") == pytest.approx(40.0)
    assert read("device.busy_ms_per_proof") == pytest.approx(250.0)
    assert read("kernels.ntt_roofline") == pytest.approx(100 * roofline.ntt_work_s(2, 2, 20, 16) / 0.1)
    assert read("kernels.merkle_roofline") == pytest.approx(
        100 * roofline.merkle_work_s(2, 2, 20, 16, 1) / 0.03)
    ctx["trace"] = None
    assert read("device.idle_share") is None and read("kernels.ntt_roofline") is None


def test_roofline_counts():
    # one transform of 2^20 over 16 limbs: 2^20 * 20 radix-2 outputs at
    # 2 * 2 * 32^2 int8 operations over 1,979 TOP/s
    assert roofline.ntt_bound_s(1 << 20) == pytest.approx((1 << 20) * 20 * 4096 / 1979e12)
    t = 1 << 20
    assert roofline.ntt_work_s(2, 2, 20, 16) == pytest.approx(
        2 * (1 + 16 + 2) * roofline.ntt_bound_s(t) + 17 * roofline.ntt_bound_s(2 * t))
    leaves = 2 * 16 * t + 32 * t + sum(16 * t >> k for k in range(21)) + \
        sum(32 * t >> k for k in range(22))
    nodes = leaves - (3 + 21 + 22)
    assert roofline.merkle_work_s(2, 2, 20, 16, 1) == pytest.approx(
        roofline.blake2s_bound_s(leaves, nodes))


def test_busy_union_and_breakdown():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    from torch.autograd import DeviceType

    def ev(name, s, e, dev):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=s, end=e))
    events = [ev("ntt_level_mma_kernel", 0, 100, DeviceType.CUDA),
              ev("blake2s_kernel", 150, 200, DeviceType.CUDA),
              ev("blake2s_kernel", 400, 450, DeviceType.CUDA),
              ev(trace.CALL_RANGE, 0, 500, DeviceType.CUDA),
              ev("aten::copy_", 90, 160, DeviceType.CPU),
              ev("prove", 0, 500, DeviceType.CPU),
              ev("aten::item", 190, 420, DeviceType.CPU)]
    got = trace.read(events)
    assert got["busy_s"] == pytest.approx(200e-6)
    assert got["groups"]["blake2s"] == pytest.approx(100e-6)
    assert got["device_ops"][0] == ["ntt_level_mma_kernel", pytest.approx(100e-6)]
    assert got["idle_gaps"] == [["aten::item", pytest.approx(200e-6)],
                                ["aten::copy_", pytest.approx(50e-6)]]


def tiny_spec(tmp_path, lanes=1):
    """A copy of the benchmark with a 16-row traffic mix, a cell of it, and
    a metric of its own: all added as files."""
    import shutil

    shutil.copytree(HERE, tmp_path / "stark_bench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "quadratic_vdf.tiny", "config": "quadratic_vdf",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "harness.calls", "unit": "calls", "better": "lower",
                               "source": "host_clock", "layer": "harness",
                               "moves": "proofs_per_s", "workloads": ["quadratic_vdf.tiny"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("quadratic_vdf.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "stark_bench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"log_rows": 4, "pool": 2, "lanes": lanes, "trace_calls": 1, "why": "test"}))
    (tmp_path / "stark_bench" / "metrics" / "harness.calls.py").write_text(
        "def read(ctx):\n    return ctx['calls']\n")
    return Spec(str(tmp_path / "BENCHMARK.json"), str(tmp_path / "stark_bench"))


def run_tiny(spec, trace_run=0, seed=2**31 + 7):
    args = harness.parse(["--workload", "quadratic_vdf.tiny", "--seed", str(seed),
                          "--seconds", "0.01", "--trace", str(trace_run)])
    return harness.run(args, spec, torch.device("cpu"), log=lambda *a, **k: None)


def test_a_run_prints_the_contracts_line_and_a_new_metric(tmp_path):
    spec = tiny_spec(tmp_path)
    line = run_tiny(spec)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"setup_s", "proofs_per_s", "prove_p90_s", "peak_device_gib"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    traced = run_tiny(spec, trace_run=1)
    assert list(traced)[-2:] == ["breakdown", "compared"] and traced["correct"] is True
    assert traced["metrics"]["harness.calls"]["value"] >= 2
    assert {"busy_s", "window_s"} <= set(traced["device"])
    json.dumps(traced)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_broken_timed_path_is_judged_not_correct(tmp_path, monkeypatch, fault):
    spec = tiny_spec(tmp_path)
    call = Program.call
    last = {}

    def broken(self, idx):
        proofs = call(self, idx)
        if fault == "state_unchanged":  # the previous call's proofs come back
            proofs, last["p"] = last.get("p", proofs), proofs
        else:  # one DEEP value altered where it is produced
            for pf in proofs:
                pf.f_at_z_m[0] = (pf.f_at_z_m[0] + 1) % spec_p(spec)
        return proofs

    monkeypatch.setattr(Program, "call", broken)
    line = run_tiny(spec)
    assert line["correct"] is False and line["failed"] >= 1


def spec_p(spec):
    return int(spec.config("quadratic_vdf")["field"]["p"], 16)


def test_distinct_witnesses_in_one_batch_are_judged_not_correct(tmp_path):
    """Prover.prove_batch proves its lanes under the first lane's instance,
    so the lanes after the first do not prove their own VDF statement."""
    spec = tiny_spec(tmp_path, lanes=2)
    # seed 12 has the judge recompute the pool's second witness, lane 1
    assert traffic.draw(spec.traffic("tiny"), 12, spec_p(spec))[1] == 1
    assert run_tiny(spec, seed=12)["correct"] is False


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; import stark_bench.run, stark_bench.control, "
            "stark_bench.program; from stark_bench.program import Program; import "
            "hodor_tpu_torch.prover, hodor_tpu_torch.models; "
            "print(stark_bench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "-m", "stark_bench.run", "--workload",
                          "quadratic_vdf.seq_2p20", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "stark_bench.run", "--workload",
                          "quadratic_vdf.seq_2p20", "--seed", "5", "--seconds", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
