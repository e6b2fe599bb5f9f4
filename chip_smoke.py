#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hodor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit from nvidia-smi;
  2. build: compiles the CUDA kernels from hodor_tpu_torch/csrc into
     build/ and prints the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card,
     on seeded random canonical inputs at the shapes the prove gives it;
     outputs must be bit-equal (tolerance 0: every output is canonical);
     kernel and plain times from CUDA events after a warm-up;
  4. goldens: the port proves fib_f257 and vdf_fstark_t32 on the card;
     proof bytes and challenge logs must equal tests/golden/, and the
     port's verifier must accept;
  5. at size: a quadratic VDF over F_STARK at 2^20 rows,
     lde factor 16, FRI to a constant: prover set-up, a cold and a warm
     prove with synchronized stage walls and peak device memory, the
     verifier's acceptance and its rejection of a tampered proof. Launch
     counts are zeroed just before the set-up and read after the cold
     prove and its verify; every kernel must have launched.

The line before the last holds the kernels' JSON record; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG_ROWS = 20

KERNEL_INFO = {
    "mont_mul": ("hodor_tpu_torch/csrc/mont_mul.cu", "hodor_tpu/field/pallas_kernels.py:283"),
    "addsub": ("hodor_tpu_torch/csrc/addsub.cu", "hodor_tpu/field/pallas_kernels.py:878"),
    "blake2s": ("hodor_tpu_torch/csrc/blake2s.cu", "hodor_tpu/field/pallas_kernels.py:787"),
    "ntt_level": ("hodor_tpu_torch/csrc/ntt_level.cu", "hodor_tpu/field/pallas_kernels.py:1384"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` calls, CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_canonical(field, shape, gen, device):
    """Seeded uniform limbs with the top limb cut below p's top bit, so
    every value is < p (a valid Montgomery-form element)."""
    import torch

    limbs = torch.randint(0, 1 << 16, shape + (field.n16,), generator=gen, dtype=torch.int32)
    top_bits = field.num_bits - 1 - 16 * (field.n16 - 1)
    limbs[..., -1] &= (1 << top_bits) - 1
    return limbs.to(device)


def phase_kernels(dev):
    """Each kernel against its plain version; returns {name: record}."""
    import torch

    from hodor_tpu_torch.field import F_STARK, LimbOps
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.merkle.blake2s import keyed_midstate
    from hodor_tpu_torch.ntt.matmul import dft_matrix, level_twiddles

    field = F_STARK
    ops = LimbOps(field, dev)
    gen = torch.Generator().manual_seed(2024)
    n = 1 << 20
    records = {name: {"max_abs_err": 0, "cases": []} for name in K.KERNELS}

    def compare(name, case, kernel_fn, plain_fn, reps=20, plain_reps=3):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}/{case}: shape/dtype {got.shape} {got.dtype} "
                                 f"vs {want.shape} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if err != 0:
            raise AssertionError(f"{name}/{case}: kernel differs from plain version, "
                                 f"max abs limb error {err}")
        ms = cuda_time_ms(kernel_fn, reps)
        plain_ms = cuda_time_ms(plain_fn, plain_reps)
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({"case": case, "ms": ms, "plain_ms": plain_ms})
        log(f"kernel {name:9s} {case:34s} bit-equal  kernel {ms:9.3f} ms  plain {plain_ms:10.3f} ms")

    a = random_canonical(field, (n,), gen, dev)
    b = random_canonical(field, (n,), gen, dev)
    s = random_canonical(field, (), gen, dev)
    compare("mont_mul", "2^20 x 16 limbs",
            lambda: K.mont_mul(field, a, b), lambda: K.mont_mul_plain(field, a, b))
    compare("mont_mul", "2^20 x scalar (stride 0)",
            lambda: K.mont_mul(field, a, s), lambda: K.mont_mul_plain(field, a, s))
    for mode in ("add", "sub"):
        compare("addsub", f"{mode} 2^20 x 16 limbs",
                lambda: K.addsub(field, a, b, mode), lambda: K.addsub_plain(field, a, b, mode))
    compare("addsub", "sub 2^20 x scalar (stride 0)",
            lambda: K.addsub(field, a, s, "sub"), lambda: K.addsub_plain(field, a, s, "sub"))
    del a, b
    # the LDE's coset shift at the f-LDE's width: coefficients (R, 1, T)
    # read with stride 0 over the factor axis, against powers (factor, T)
    coeffs = random_canonical(field, (2, 1, n // 2), gen, dev)
    pw = random_canonical(field, (16, n // 2), gen, dev)
    compare("mont_mul", "LDE shift (2,1,2^19) x (16,2^19)",
            lambda: K.mont_mul(field, coeffs, pw), lambda: K.mont_mul_plain(field, coeffs, pw),
            reps=5, plain_reps=1)
    del coeffs, pw

    mid = keyed_midstate()
    words = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, dtype=torch.int32).to(dev)
    compare("blake2s", "2^20 leaves (32 B)",
            lambda: K.blake2s(words, 32, mid), lambda: K.blake2s_plain(words, 32, mid))
    nodes = words.reshape(n // 2, 16)
    compare("blake2s", "2^19 nodes (64 B)",
            lambda: K.blake2s(nodes, 64, mid), lambda: K.blake2s_plain(nodes, 64, mid))
    del words, nodes

    # NTT levels at 2^20 elements: the four-step's first level (S = 128
    # over C columns, with its twiddle table and without), the terminal
    # level with the scalar 1/N, and the small radices
    x = random_canonical(field, (64, 128, 128), gen, dev)
    tw = random_canonical(field, (128, 128), gen, dev)
    w128 = dft_matrix(ops, 128, False)
    compare("ntt_level", "S=128 C=128 B=64 no twiddle",
            lambda: K.ntt_level(field, x, w128), lambda: K.ntt_level_plain(field, x, w128),
            reps=5, plain_reps=1)
    compare("ntt_level", "S=128 C=128 B=64 twiddle table",
            lambda: K.ntt_level(field, x, w128, tw),
            lambda: K.ntt_level_plain(field, x, w128, tw), reps=5, plain_reps=1)
    # the first four-step level of a 2^20-point NTT (f-LDE, B = R x factor
    # of them) and of a 2^21-point one (g-LDE), with their own twiddle tables
    for log_n, bsz in ((20, 2), (21, 1)):
        cols = (1 << log_n) // 128
        xw = random_canonical(field, (bsz, 128, cols), gen, dev)
        tww = level_twiddles(ops, 1 << log_n, 128, False)
        compare("ntt_level", f"S=128 C={cols} B={bsz} 2^{log_n} twiddles",
                lambda: K.ntt_level(field, xw, w128, tww),
                lambda: K.ntt_level_plain(field, xw, w128, tww), reps=5, plain_reps=1)
    del xw, tww
    xt = x.reshape(n // 128, 128, 1, field.n16)
    ninv = ops.const(field.inv(1 << 20))
    w128i = dft_matrix(ops, 128, True)
    compare("ntt_level", "S=128 C=1 scalar 1/N (inverse)",
            lambda: K.ntt_level(field, xt, w128i, ninv),
            lambda: K.ntt_level_plain(field, xt, w128i, ninv), reps=5, plain_reps=1)
    for size in (64, 8):
        xs = x.reshape(n // size, size, 1, field.n16)
        ws = dft_matrix(ops, size, False)
        compare("ntt_level", f"S={size} C=1 B=2^20/{size}",
                lambda: K.ntt_level(field, xs, ws), lambda: K.ntt_level_plain(field, xs, ws),
                reps=5, plain_reps=1)
    return records


def phase_goldens(dev) -> None:
    from hodor_tpu_torch.air import Fibonacci, TestTraceSystem
    from hodor_tpu_torch.field import F257, F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    golden = os.path.join(ROOT, "tests", "golden")

    def check(name, witness, props, field):
        t0 = time.perf_counter()
        prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
        proof = prover.prove(witness)
        wall = time.perf_counter() - t0
        if not Verifier(props, lde_factor=16).verify(proof):
            raise AssertionError(f"{name}: the port's verifier rejects the card's proof")
        with open(os.path.join(golden, f"{name}.proof"), "rb") as f:
            if serialize_proof(proof, field) != f.read():
                raise AssertionError(f"{name}: proof bytes differ from the golden vector")
        with open(os.path.join(golden, f"{name}.challenges.json")) as f:
            expected_log = [tuple(e) for e in json.load(f)]
        got_log = [(k, v if isinstance(v, str) else str(v))
                   for k, v in prover.last_transcript.log]
        if got_log != expected_log:
            raise AssertionError(f"{name}: challenge sequence differs from the golden vector")
        log(f"golden {name}: proof bytes and challenge log equal, verified "
            f"(set-up + prove {wall:.2f} s)")

    fib = Fibonacci(F257, final_b=5, at_step=3)
    tracer = TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    witness, props = tracer.into_arp()
    check("fib_f257", witness, props, F257)
    witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
    check("vdf_fstark_t32", witness, props, F_STARK)


def phase_at_size(dev):
    """Returns the launch counts of the set-up + cold prove + verify."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    field = F_STARK
    t0 = time.perf_counter()
    witness, props = VDF(field, 1, 2, (1 << LOG_ROWS) - 1).into_arp()
    log(f"at size: quadratic VDF 2^{LOG_ROWS} rows, witness {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
    torch.cuda.synchronize()
    log(f"at size: prover set-up {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    proof = prover.prove(witness)
    cold = time.perf_counter() - t0
    verifier = Verifier(props, lde_factor=16)
    t0 = time.perf_counter()
    if not verifier.verify(proof):
        raise AssertionError("the verifier rejects the 2^%d-row proof" % LOG_ROWS)
    verify_s = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    peak_cold = torch.cuda.max_memory_allocated()
    log(f"at size: cold prove {cold:.3f} s (stage walls: {prover.last_timings.to_json()})")
    log(f"at size: verify {verify_s:.3f} s -> accepted")
    log(f"at size: launches in set-up + cold prove + verify: {json.dumps(counts)}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prover.prove(witness)
    warm = time.perf_counter() - t0
    peak_warm = torch.cuda.max_memory_allocated()
    log(f"at size: warm prove {warm:.3f} s (stage walls: {prover.last_timings.to_json()})")
    log(f"at size: peak device memory cold {peak_cold / 2**30:.3f} GiB, "
        f"warm {peak_warm / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    if not verifier.verify(proof):
        raise AssertionError("the verifier rejects the warm proof")
    proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % field.p
    if verifier.verify(proof):
        raise AssertionError("the verifier accepts a tampered f_at_z_m[0]")
    log("at size: warm proof accepted; tampered f_at_z_m[0] rejected")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hodor_tpu_torch.field import kernels as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = K.build_kernels(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, ROOT)}")

    records = phase_kernels(dev)
    phase_goldens(dev)
    counts = phase_at_size(dev)

    kernels = []
    for name in K.KERNELS:
        source, replaces = KERNEL_INFO[name]
        rec = records[name]
        first = rec["cases"][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": rec["max_abs_err"],
            "ms": first["ms"], "plain_ms": first["plain_ms"], "cases": rec["cases"],
        })
    log(f"device: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
