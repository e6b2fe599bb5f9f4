"""The port's measuring command: NTT rate, prove wall, FRI ladder pair.

    python -m hodor_tpu_torch.tools.bench [--mode ntt|prove|fri] [--device cpu] [flags]

The counterpart of the JAX package's `bench.py` (NTT throughput, prove
wall) and of `scripts/tpu_bench.py`'s `check`, `ntt` and `fri`. Each run
prints exactly one JSON line on stdout; its commentary goes to stderr.
Every line names the device (`torch.cuda.get_device_name(0)`, or "cpu"),
the card's power limit from nvidia-smi (null on the CPU), the timed
samples with their median, smallest and largest, and whether the output
is right (`correct` or `verified`). It runs on the card unless
`--device cpu` is given; with no card it says so and returns 1. On the
CPU every metric name starts with `cpu_` and no roofline share is given.

A flag that the mode does not read is refused. A metric's name carries
each setting that the mode reads and that is off its default (the field,
the level form, the batch), so that no two runs share a name.

Modes:
  ntt    (`--log-n`, `--field`, `--impl`, `--batch`, `--check`, `--seed`)
         the natural-order NTT of seeded limbs, (2^n, n16) or (B, 2^n,
         n16): 5 windows, each a chain of `--reps` transforms (each taking
         the previous output) between two CUDA events, after one such
         window as a warm-up; the median ms per call. Rate in
         field-muls/s at (N/2)·log2 N a transform.
         `bound_ms`: the H100's least time for the call (tools/roofline.py
         `ntt_bound_ms`: one read and one write of the array, or the int8
         operations of a radix-2 transform, whichever is larger; no count
         of the radices the port picked, which `levels_int8_ms` gives);
         `vs_sol` = `vs_baseline` = bound_ms / ms. `correct`: intt(ntt(x))
         gives x back bit for bit, three seeded outputs equal the
         polynomial's values on the host, and so does the last output of
         the timed chain; with `--check` (n <= 12) the whole output also
         equals the plain versions' on the CPU.
  prove  (`--log-rows`, `--workload`, `--impl`, `--batch`) the quadratic or
         cubic VDF over F_STARK at lde 16, FRI to a constant: kernels built
         first (`build_s`), one cold prove and `--reps` warm ones, each on
         the host clock ending in a synchronize; every proof verified
         outside the timed window; the median warm prove's stage walls on
         stderr; the peak memory allocated over the warm proves. With
         `--batch` B > 1, `Prover.prove_batch` of B copies of the witness,
         and the wall per proof.
  fri    (`--log-h1`, `--field`, `--impl`, `--seed`) the FRI ladders of h1
         = 2^n and h2 = 2^(n+1) rows, the LDEs (factor 16) of seeded
         polynomials of degree below h/16: `--reps` runs of
         `NaiveFriIop.proofs_from_ldes` after two warm-ups, each
         synchronized; `correct`: each ladder's last layer holds one value
         repeated. Then one run under torch.profiler prints the device time
         by kernel group on stderr (on the card).

The ntt and fri windows run with Python's collector off (`gc_paused`);
their lines give the cudaMalloc calls made in them
(`device_allocs_in_window`, null on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bench.py:202: the 64-core Rust reference's sustained field-mul rate, an
# estimate of that CPU prover (no device figure)
BASELINE_MULS_PER_S = 6.4e8
LDE_FACTOR = 16
WINDOWS = 5
FIELD_NAMES = ("F_STARK", "F_BLS", "F257", "F_P63")
# --impl -> LimbOps.ntt_impl; "matmul" is bench.py's name of the level form
IMPLS = {"level": "level", "matmul": "level", "two_step": "two_step", "fused": "fused"}
MAX_CHECK_LOG_N = 12
# outputs of a timed transform held against its value on the host
CHECK_POINTS = 3
# the settings each mode reads, and their defaults; a mode refuses the others
DEFAULTS = {"log_n": 16, "field": "F_STARK", "impl": "level", "log_rows": 14,
            "workload": "quadratic", "batch": 1, "log_h1": 24, "check": False, "seed": 0}
MODE_SETTINGS = {
    "ntt": ("log_n", "field", "impl", "batch", "check", "seed"),
    "prove": ("log_rows", "workload", "impl", "batch"),
    "fri": ("log_h1", "field", "impl", "seed"),
}


def parse_args(argv):
    """argv without the program name. Raises ValueError for an --impl the
    port does not have (the Pease form is not ported), for a setting the
    mode does not read, and for settings out of range."""
    ap = argparse.ArgumentParser(prog="python -m hodor_tpu_torch.tools.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=tuple(MODE_SETTINGS), default="ntt")
    ap.add_argument("--log-n", type=int, help="ntt: transform length 2^n (16)")
    ap.add_argument("--reps", type=int, default=None,
                    help="transforms a window (ntt, default 50) or warm runs (prove, fri: 5)")
    ap.add_argument("--field", choices=FIELD_NAMES, help="ntt and fri (F_STARK)")
    ap.add_argument("--impl", help="the NTT level form: level (or matmul), fused or two_step")
    ap.add_argument("--log-rows", type=int, help="prove: 2^n trace rows (14)")
    ap.add_argument("--workload", choices=("quadratic", "cubic"), help="prove (quadratic)")
    ap.add_argument("--batch", type=int, help="ntt: transforms a call; prove: lanes of "
                                              "prove_batch (1)")
    ap.add_argument("--log-h1", type=int, help="fri: h1 = 2^n rows (24)")
    ap.add_argument("--check", action="store_true", default=None,
                    help=f"ntt: also hold the output against the CPU (log-n <= {MAX_CHECK_LOG_N})")
    ap.add_argument("--seed", type=int, help="ntt and fri (0)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    foreign = [k for k in DEFAULTS if getattr(args, k) is not None
               and k not in MODE_SETTINGS[args.mode]]
    if foreign:
        raise ValueError(f"--mode {args.mode} reads no "
                         + ", ".join("--" + k.replace("_", "-") for k in foreign))
    for k, v in DEFAULTS.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    if args.impl == "pease":
        raise ValueError("--impl pease: the Pease NTT form is not ported (ROADMAP.md, "
                         "\"Not ported\"); the port's level forms are level, fused, two_step")
    if args.impl not in IMPLS:
        raise ValueError(f"--impl must be one of {sorted(IMPLS)}, not {args.impl!r}")
    args.impl = IMPLS[args.impl]
    if args.reps is None:
        args.reps = 50 if args.mode == "ntt" else 5
    if args.reps < 1 or args.batch < 1:
        raise ValueError("--reps and --batch must be at least 1")
    if args.check and args.log_n > MAX_CHECK_LOG_N:
        raise ValueError(f"--check holds the output against the CPU only up to "
                         f"--log-n {MAX_CHECK_LOG_N}")
    return args


def name_suffix(args, keys) -> str:
    """`_{value}` for each of these settings off its default (`_batch{B}`
    for the batch), so that a metric's name says what ran."""
    return "".join(f"_batch{args.batch}" if k == "batch" else f"_{getattr(args, k)}"
                   for k in keys if getattr(args, k) != DEFAULTS[k])


def field_of(name: str):
    from ..field import F257, F_BLS, F_P63, F_STARK

    return {f.name: f for f in (F_STARK, F_BLS, F257, F_P63)}[name]


def seeded_limbs(field, shape, seed: int) -> torch.Tensor:
    """bench.py:366-375's input: u16 limbs from np.random.default_rng(seed)
    with the limb that holds p's top bit cut below it (and any above it
    zero), so every value is below p. (shape..., n16) int32 on the CPU."""
    n16 = field.n16
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, size=tuple(shape) + (n16,),
                                                 dtype=np.uint32)
    top = (field.num_bits - 1) // 16
    limbs[..., top] &= (1 << (field.num_bits - 1 - 16 * top)) - 1
    limbs[..., top + 1:] = 0
    return torch.from_numpy(limbs.astype(np.int32))


def device_fields(dev: torch.device) -> dict:
    """The line's device, and the card's power limit as nvidia-smi gives it."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# device: {smi}", file=sys.stderr)
    return {"device": torch.cuda.get_device_name(0),
            "power_limit_w": float(smi.rsplit(",", 1)[1].split()[0])}


def sample_fields(samples, unit: str) -> dict:
    return {"samples": samples, "sample_unit": unit, "median": statistics.median(samples),
            "min": min(samples), "max": max(samples)}


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(dev: torch.device, host: bool = False) -> float:
    """Seconds to build (or load) the CUDA kernels on the card, and the
    host library of the native witness chains where `host`: done before
    any clock starts."""
    from ..field import kernels as K
    from ..utils.native import build_host_library

    t0 = time.perf_counter()
    if dev.type == "cuda":
        K.build_kernels()
    if host:
        build_host_library()
    return time.perf_counter() - t0


@contextlib.contextmanager
def gc_paused():
    """Python's collector off over a timed window, as timeit does: a
    collection of garbage that earlier runs left is no part of the
    function timed. (The prove wall keeps it: a user pays it there.)"""
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def device_allocs(dev: torch.device):
    """The caching allocator's cudaMalloc calls so far, None on the CPU:
    the difference over a window says whether it allocated in it."""
    return torch.cuda.memory_stats(dev).get("num_device_alloc", 0) if dev.type == "cuda" else None


def chain_ms(fn, x, reps: int, dev: torch.device):
    """(milliseconds a call of fn, the last output) over a chain of `reps`
    calls, each taking the previous output: CUDA events around the chain
    and one synchronize on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            x = fn(x)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps, x
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x)
    return (time.perf_counter() - t0) * 1e3 / reps, x


def limbs_int(limbs: torch.Tensor) -> int:
    """(n16,) u16 limbs on the CPU, least significant first -> the integer."""
    return int.from_bytes(limbs.numpy().astype("<u2").tobytes(), "little")


def points_agree(field, x, out, last, reps: int, seed: int) -> bool:
    """Outputs of the timed transform held against the host, with Python
    integers and none of the port's arithmetic. At CHECK_POINTS seeded
    (lane, i): out[lane, i] = sum_j x[lane, j] w^(i j) mod p, w = g^((p-1)/N)
    for the field's generator g, by Horner's rule (O(N) a point; the limbs
    are Montgomery forms, which a linear map keeps); and the last output
    of a chain of `reps` transforms, which is N^k times row i of x (reps
    = 2k) or of out (reps = 2k + 1), or row -i where k is odd, since the
    transform applied twice is N times the reversal."""
    p, n, w = field.p, x.shape[-2], 2 * field.n16
    xs, outs, lasts = (t.reshape(-1, n, field.n16).cpu() for t in (x, out, last))
    k = reps // 2
    base, scale = (xs if reps % 2 == 0 else outs), pow(n, k, p)
    rng = np.random.default_rng(seed + 1)
    coeffs = {}  # lane -> x[lane] as ints, highest power first
    for lane, i in zip(rng.integers(0, len(xs), CHECK_POINTS).tolist(),
                       rng.integers(0, n, CHECK_POINTS).tolist()):
        if lane not in coeffs:
            raw = xs[lane].numpy().astype("<u2").tobytes()
            coeffs[lane] = [int.from_bytes(raw[j:j + w], "little")
                            for j in range(len(raw) - w, -1, -w)]
        t, acc = pow(field.generator, (p - 1) // n * i, p), 0
        for c in coeffs[lane]:
            acc = (acc * t + c) % p
        row = -i % n if k % 2 else i
        if (limbs_int(outs[lane, i]) != acc
                or limbs_int(lasts[lane, i]) != scale * limbs_int(base[lane, row]) % p):
            return False
    return True


def bench_ntt(args, dev):
    """(line, the transform of the seeded input)."""
    from ..field import LimbOps
    from ..ntt import intt, ntt
    from ..ntt.matmul import level_sizes
    from .roofline import levels_ms, ntt_bound_ms

    field = field_of(args.field)
    build_s = build(dev)
    ops = LimbOps(field, dev, args.impl)
    n = 1 << args.log_n
    x = seeded_limbs(field, (n,) if args.batch == 1 else (args.batch, n), args.seed).to(dev)
    with gc_paused():
        out = ntt(ops, x)  # checked below
        chain_ms(lambda v: ntt(ops, v), x, args.reps, dev)  # the warm-up window
        allocs = device_allocs(dev)
        samples = []
        for _ in range(WINDOWS):
            last = None  # each window starts with the memory the warm-up's did
            ms, last = chain_ms(lambda v: ntt(ops, v), x, args.reps, dev)
            samples.append(ms)
        allocs = None if allocs is None else device_allocs(dev) - allocs
    correct = (torch.equal(intt(ops, out), x)
               and points_agree(field, x, out, last, args.reps, args.seed))
    if args.check:
        want = ntt(LimbOps(field, torch.device("cpu"), args.impl), x.cpu())
        correct = correct and torch.equal(out.cpu(), want)
    synchronize(dev)
    ms = statistics.median(samples)
    sizes = level_sizes(field, n)
    bound, bound_by = ntt_bound_ms(n, field.n16, args.batch)
    value = args.batch * (n // 2) * args.log_n / (ms / 1e3)
    on_card = dev.type == "cuda"
    name = (f"ntt_2^{args.log_n}_{field.name}_field_muls_per_s_per_chip"
            + name_suffix(args, ("impl", "batch")))
    print(f"# ntt 2^{args.log_n} x{args.batch} over {field.name} ({args.impl}; levels {sizes}): "
          f"{ms:.4f} ms a call, {value:.4e} field-muls/s; bound {bound:.4f} ms ({bound_by})",
          file=sys.stderr)
    line = {
        "metric": ("" if on_card else "cpu_") + name, "value": value, "unit": "field_muls/s",
        "vs_baseline": bound / ms if on_card else None,
        "vs_sol": bound / ms if on_card else None,
        "vs_cpu_estimate": value / BASELINE_MULS_PER_S,
        "ms_per_call": ms, "ms_per_transform": ms / args.batch,
        "bound_ms": bound, "bound_by": bound_by, "level_sizes": sizes,
        "levels_int8_ms": levels_ms(sizes, n, field.n16, args.batch),
        "field": field.name, "impl": args.impl, "log_n": args.log_n, "batch": args.batch,
        "reps": args.reps, "windows": WINDOWS, "build_s": build_s,
        "timing": "cuda_events_chain" if on_card else "host_clock_chain",
        "device_allocs_in_window": allocs, "points_checked": CHECK_POINTS,
        "correct": correct, "checked_against_cpu": args.check,
        **sample_fields(samples, "ms a call"),
    }
    return line, out


def reference_prove_estimate_s(prover, t_rows: int, lde_factor: int) -> float:
    """bench.py:214-251, verbatim: a field-mul count model of the
    reference prover on this instance (src/prover/mod.rs:66-174 stage by
    stage) at the 6.4e8 muls/s 64-core anchor; Blake2s hashing excluded.
    Terms (log2 T = lgT, D = T*max_power, h1 = T*lde, h2 = D*lde):
      witness iFFTs   R * (T/2) lgT
      f LDEs          R * lde * ((T/2) lgT + T)      coset shift + NTT
      ALI G           M * p * ((T/2) lgT + T) + 5D   masked-term LDEs,
                                                     divisors + eval
      g iFFT + LDE    (D/2) lgD + lde * ((D/2) lgD + D)
      DEEP            (2M + 3) h1 + 2 h2             accumulation + inv
      FRI folds       3 (h1 + h2)
    """
    props = prover.arp.properties
    r = props.num_registers
    m = len(prover.ali.all_masks)
    p = prover.ali.max_constraint_power
    t, lde = t_rows, lde_factor
    lg_t = int(math.log2(t))
    d = t * p
    lg_d = int(math.log2(d))
    h1 = t * lde
    h2 = d * lde
    muls = (
        r * (t // 2) * lg_t
        + r * lde * ((t // 2) * lg_t + t)
        + m * p * ((t // 2) * lg_t + t) + 5 * d
        + (d // 2) * lg_d + lde * ((d // 2) * lg_d + d)
        + (2 * m + 3) * h1 + 2 * h2
        + 3 * (h1 + h2)
    )
    return muls / BASELINE_MULS_PER_S


def bench_prove(args, dev):
    """(line, the proofs of the last warm run: one, or the batch's lanes)."""
    from ..field import F_STARK
    from ..models import VDF, CubicVDF
    from ..prover import Prover
    from ..verifier import Verifier

    t_rows = 1 << args.log_rows
    model = (CubicVDF if args.workload == "cubic" else VDF)(F_STARK, 1, 2, t_rows - 1)
    build_s = build(dev, host=model.native)
    t0 = time.perf_counter()
    witness, props = model.into_arp()
    witness_s = time.perf_counter() - t0
    prover = Prover(props.clone(), lde_factor=LDE_FACTOR, fri_final_degree_plus_one=1,
                    device=dev, ntt_impl=args.impl)
    verifier = Verifier(props, lde_factor=LDE_FACTOR)
    lanes = args.batch

    def run():
        """(proofs, wall, verified): the wall ends in a synchronize; the
        proofs are verified after it."""
        t0 = time.perf_counter()
        proofs = prover.prove_batch([witness] * lanes) if lanes > 1 else [prover.prove(witness)]
        synchronize(dev)
        wall = time.perf_counter() - t0
        return proofs, wall, all(verifier.verify(p) for p in proofs)

    _, cold, verified = run()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    walls, timings = [], []
    for _ in range(args.reps):
        proofs, wall, ok = run()
        verified = verified and ok
        walls.append(wall)
        timings.append(prover.last_timings)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    warm = statistics.median(walls)
    mid = sorted(range(len(walls)), key=walls.__getitem__)[len(walls) // 2]
    print(f"# {args.workload} VDF 2^{args.log_rows} rows x{lanes}: build {build_s:.3f} s, "
          f"witness ({'native' if model.native else 'python'}) {witness_s:.3f} s, cold "
          f"{cold:.4f} s, warm {walls} s; stage walls of the median warm run:", file=sys.stderr)
    print(timings[mid].report(), file=sys.stderr)
    est_ref = reference_prove_estimate_s(prover, t_rows, LDE_FACTOR)
    value = warm / lanes
    name = (f"{args.workload}_vdf_2^{args.log_rows}_rows_prove_wall_s" if lanes == 1 else
            f"{args.workload}_vdf_2^{args.log_rows}_rows_batch{lanes}_prove_per_proof_s"
            ) + name_suffix(args, ("impl",))
    line = {
        "metric": ("" if dev.type == "cuda" else "cpu_") + name, "value": value, "unit": "s",
        "vs_baseline": est_ref / value, "vs_cpu_estimate": est_ref / value,
        "reference_estimate_s": est_ref,
        "cold_prove_s": cold, "compile_est_s": cold - warm, "build_s": build_s,
        "witness_s": witness_s, "peak_gib": peak_gib, "stage_walls_synced": True,
        "stage_walls_s": timings[mid].as_dict(),
        "workload": args.workload, "log_rows": args.log_rows, "batch": lanes,
        "impl": args.impl, "reps": args.reps, "verified": verified,
        **sample_fields(walls, "s a call"),
    }
    return line, proofs


def final_layer_constant(proto, lde_values) -> bool:
    """Whether a FRI ladder to a constant ended in one: its last layer (the
    LDE itself where it folded no time) holds one value repeated."""
    last = proto.intermediate_values[-1] if proto.intermediate_values else lde_values
    return bool((last == last[..., :1, :]).all())


def bench_fri(args, dev):
    """(line, the two prototypes of the last run)."""
    from ..field import LimbOps
    from ..fri.fri import NaiveFriIop
    from ..ntt import lde
    from .profile_prove import _group

    field = field_of(args.field)
    build_s = build(dev)
    ops = LimbOps(field, dev, args.impl)
    rows = (1 << args.log_h1, 1 << (args.log_h1 + 1))
    ldes = [lde(ops, seeded_limbs(field, (h // LDE_FACTOR,), args.seed + i).to(dev), LDE_FACTOR)
            for i, h in enumerate(rows)]

    def run():
        protos = NaiveFriIop.proofs_from_ldes(ops, ldes, LDE_FACTOR, 1)
        synchronize(dev)
        return protos

    samples = []
    with gc_paused():
        run()
        run()  # a second warm-up: the allocator's cache holds every size by now
        allocs = device_allocs(dev)
        for _ in range(args.reps):
            protos = None  # each run starts with the memory the warm-ups' did
            t0 = time.perf_counter()
            protos = run()
            samples.append((time.perf_counter() - t0) * 1e3)
        allocs = None if allocs is None else device_allocs(dev) - allocs
    correct = all(final_layer_constant(p, v) for p, v in zip(protos, ldes))
    ms = statistics.median(samples)
    print(f"# fri pair h1 = 2^{args.log_h1} over {field.name}: {ms:.3f} ms, last layers "
          f"{'constant' if correct else 'NOT constant'}", file=sys.stderr)
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        groups = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                g = groups.setdefault(_group(e.name), [0, 0.0])
                g[0] += 1
                g[1] += e.time_range.elapsed_us()
        print("# device time by kernel group, one profiled run:", file=sys.stderr)
        for g, (count, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"#   {g:28s} {count:6d} launches {us / 1e3:10.3f} ms", file=sys.stderr)
    name = f"fri_pair_h1_2^{args.log_h1}_ms" + name_suffix(args, ("field", "impl"))
    line = {
        "metric": ("" if dev.type == "cuda" else "cpu_") + name, "value": ms, "unit": "ms",
        "field": field.name, "impl": args.impl, "log_h1": args.log_h1, "lde_factor": LDE_FACTOR,
        "reps": args.reps, "build_s": build_s, "device_allocs_in_window": allocs,
        "correct": correct, **sample_fields(samples, "ms a call"),
    }
    return line, protos


MODES = {"ntt": bench_ntt, "prove": bench_prove, "fri": bench_fri}


def main(argv) -> int:
    """argv[0] is the program's name. Prints the mode's JSON line; returns
    0 where its output is right, else 1."""
    args = parse_args(argv[1:])
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("bench: torch sees no CUDA device; pass --device cpu to run the plain "
                  "versions on the CPU", file=sys.stderr)
            return 1
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, not {args.device!r}")
    fields = device_fields(dev)
    line, _ = MODES[args.mode](args, dev)
    line.update(fields)
    print(json.dumps(line), flush=True)
    return 0 if line.get("correct", line.get("verified")) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
