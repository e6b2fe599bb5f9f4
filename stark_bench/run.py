"""One run of one cell of the benchmark.

    python -m stark_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the program, builds or loads its kernels from build/ in the
checkout, draws the pool's VDF start values from the seed, builds each
witness with the program's own model (its native chain), and warms up
with one call of the cell's own shape. The window then makes one call
after another, one client in a closed loop, for --seconds; each call is
a new instance to the program (its Prover built, then its proof), and
each proof proves another witness than the proof before it. The objects
set-up leaves are frozen out of the cycle collector's passes for the
window (gc.freeze); the collections that still run in it are timed on
stderr.
With --trace 1 a few more calls run under torch.profiler. Then the
program's state is let go, the plain reference (stark_bench/reference)
works the judged witness's proof out again from its start values, and
every proof of that witness from the window is compared with it. The
last line of stdout is one JSON object; the numbers compared, each with
its limit, are the last lines of stderr.

Exits 2 without the CUDA devices the cell asks for, 3 where jax, jaxlib,
flax or hodor_tpu were loaded, and prints no result in either case.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from stark_bench.spec import ROOT, Spec  # noqa: E402

# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hodor_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m stark_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return float(out[0].rsplit(",", 1)[1].split()[0])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return None


def run(args, spec: Spec, device: torch.device, log=print):
    """The run's result line (a dict) and its compared numbers."""
    from stark_bench import judge, traffic as gen
    from stark_bench.program import Program, counters_since, flatten
    from stark_bench.reference import stark
    from stark_bench.reference.field import PlainField

    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    air = spec.air(cell["config"])
    p, lanes = int(config["field"]["p"], 16), mix["lanes"]
    starts, judged = gen.draw(mix, args.seed, p)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    program = Program(config, mix["log_rows"], starts, device)
    program.call(gen.call(mix, -1))  # the warm call, of the witness before call 0's
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = program.counters()
    collections = []

    def gc_timer(phase, info, _t=[0.0]):
        if phase == "start":
            _t[0] = time.perf_counter()
        else:
            collections.append((info["generation"], time.perf_counter() - _t[0]))

    gc.collect()
    gc.freeze()
    gc.callbacks.append(gc_timer)
    stages, latencies, kept = {}, [], []
    calls = 0
    w0 = time.perf_counter()
    setup_s = w0 - T0
    log(f"# set-up {setup_s:.3f} s; window of {args.seconds} s", file=sys.stderr)
    while True:
        idx = gen.call(mix, calls)
        t0 = time.perf_counter()
        proofs = program.call(idx)
        t1 = time.perf_counter()
        calls += 1
        latencies += [t1 - t0] * lanes
        for k, s in program.last_stages().items():
            stages[k] = stages.get(k, 0.0) + s
        kept += [proof for i, proof in zip(idx, proofs) if i == judged]
        if t1 - w0 >= args.seconds and calls * lanes >= len(starts):
            break
    window_s = t1 - w0
    gc.callbacks.remove(gc_timer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counts = counters_since(before, program.counters())
    log(f"# window {window_s:.3f} s, {calls} calls, {calls * lanes} proofs; call latency "
        f"first {latencies[0]:.4f} s, median {sorted(latencies)[len(latencies) // 2]:.4f} s, "
        f"max {max(latencies):.4f} s; cycle collections {len(collections)}, "
        f"{sum(s for _g, s in collections):.4f} s (generation 2: "
        f"{sum(1 for g, _s in collections if g == 2)})", file=sys.stderr)

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from stark_bench import trace as tr

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            sync()
            t0 = time.perf_counter()
            for j in range(mix["trace_calls"]):
                with torch.profiler.record_function(tr.CALL_RANGE):
                    program.call(gen.call(mix, calls + j))
            sync()
            traced_s = time.perf_counter() - t0
        trace = tr.read(prof.events())
        trace.update(window_s=traced_s, proofs=mix["trace_calls"] * lanes)
        del prof

    del program, proofs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    F = PlainField(p, config["field"]["generator"], device)
    reference = stark.prove(F, air, starts[judged], gen.steps(mix), config["lde_factor"],
                            config["fri_final_degree_plus_one"],
                            log=lambda text: log(text, file=sys.stderr))
    sync()
    flat = [flatten(proof) for proof in kept]
    checks = judge.compare(reference, flat)
    log(f"# reference proof of witness {judged}: {time.perf_counter() - t0:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0:.3f} GiB",
        file=sys.stderr)

    ctx = {"setup_s": setup_s, "window_s": window_s, "proofs": calls * lanes, "calls": calls,
           "latencies": latencies, "peak_bytes": peak, "stages": stages,
           "launches": counts["launches"], "forms": counts["forms"], "trace": trace,
           "config": config, "traffic": mix,
           "shape": (config["registers"], config["max_constraint_degree"], mix["log_rows"],
                     config["lde_factor"])}
    metrics = {}
    for m in spec.metrics(args.workload, bool(args.trace)):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit_w": _power_limit() if cuda else None}
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    line = {"correct": judge.passed(checks), "attempted": calls * lanes,
            "failed": judge.failed(reference, flat),
            "metrics": metrics, "device": dev}
    if trace is not None:
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["compared"] = checks
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"stark_bench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run(args, spec, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"stark_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
