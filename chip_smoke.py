#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hodor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit from nvidia-smi;
  2. build: compiles the CUDA kernels from hodor_tpu_torch/csrc into
     build/ (one nvcc per source, all at once) and the host library of
     the native witness chains (g++), and prints the seconds of each;
  3. kernels: each of the seven kernels (and s8dot, the contraction of
     dft_reduce alone, and mont_pow, the static power in mont_mul.cu)
     against its plain PyTorch version on the card, on seeded random
     canonical inputs at the shapes the prove gives it; ntt_level in its
     three bodies (tensor cores, butterflies in registers, limbs on the
     integer pipe: the one the wrapper picks against the plain version,
     the others that take the shape beside it) and dft_reduce in both of
     its bodies on the same inputs, timed in turn, dft_reduce also
     on ragged shapes, a 64-bit field and a random W that is no fold of a
     DFT matrix; s8dot at a bare launch's shape and at the fused level's
     product shape beside torch._int_mm; outputs must be bit-equal
     (tolerance 0: every output is canonical); the same at F_BLS's and
     F_P63's widths (16 and 4 limbs with a nearly full top word), the NTT
     levels at the radix-4 and radix-2 shapes of their transforms on the
     butterfly body with the limb body beside it, at every x = p - 1 too;
     addsub in each of its three bodies (flat, grid, general) at every
     width, p - 1 against p - 1, 0 and 1 and ragged sizes among them,
     and fri_fold with a ragged half, interleaved halves and lanes at
     every width; for every case three times: `ms`, CUDA events around
     calls issued back to back after a warm-up (the host's time where it
     exceeds the card's); `device_ms`, the card's time of one call, from
     the calls captured in a CUDA graph and replayed between CUDA
     events, cycling over copies of their operands (`device_copies`) so
     that none reads them from L2
     (`device_by` "graph"; "profiler" where a call cannot be captured:
     the sum of its device intervals under torch.profiler); `host_us`,
     the host clock over calls that nothing synchronises, the median of
     five batches (both from hodor_tpu_torch/tools/launch_cost.py);
     beside the plain version's
     time, the least time the card could take (bytes over 3.35 TB/s or
     operations over the peak of their type, whichever is larger) and,
     where one PyTorch call computes the same function, that call's time.
     Then the three forms of the NTT level on one x and twiddle table,
     bit-equal;
  4. goldens: the port proves fib_f257, vdf_fstark_t32 and
     cubic_vdf_fstark_t32 on the card, and vdf_fstark_t32 again under
     the "two_step" and "fused" level forms; proof bytes and challenge
     logs must equal tests/golden/, and the port's verifier must accept;
     then hodor_tpu_torch/tools/gen_golden.py writes the six files on the
     card into a temporary directory, each byte-equal to tests/golden/;
  5. main path at size: a quadratic VDF over F_STARK at 2^20 rows, lde
     factor 16, FRI to a constant, its witness from the native chain as a
     packed array: prover set-up, a cold and a warm prove with
     synchronized stage walls and peak device memory, encode_witness
     alone, the verifier's acceptance and its rejection of a tampered
     proof; then a 2^14-row prove from the Python chain's lists and from
     the native array, whose proof bytes must be equal;
  6. the cubic VDF (4 registers) the same way at 2^20 rows;
  7. the quadratic VDF at 2^16 rows under each level form, from the
     Python chain's lists: the three serialized proofs must be equal and
     each must verify; the "fused" prove must run the tensor-core body of
     dft_reduce;
  8. batch proving (Prover.prove_batch) of the quadratic VDF at 2^20 rows
     on B = 2 lanes: phase 5's witness and the native witness of the start
     (3, 5) under phase 5's instance; a cold and a warm batch with stage
     walls and peak device memory; lane 0 must equal phase 5's warm proof
     bytes and lane 1 its own sequential prove, lane 0 must verify and
     lane 1 be rejected; the warm batch's launches per kernel beside phase
     5's warm single prove: fri_fold and blake2s as often as in the single
     prove, no kernel B times as often, the tensor-core body of ntt_level
     run; the mont_mul bodies of both and the body of the G and DEEP
     products by a per-lane challenge;
  8b. B = 4 distinct lanes at 2^18 rows, each byte-equal to its
     sequential prove; the warm batch's wall per proof beside a warm single
     prove;
  9. at 2^16 rows: a checkpointed prove and resumes after each of the four
     stages, from_config, all byte-equal to a plain prove; the root of the
     host Blake2s library's tree over 2^16 leaves equal to the device
     tree's;
 10. the quadratic VDF over F_BLS at 2^20 rows, lde factor 16, FRI to a
     constant, native witness, as phase 5: every ntt_level launch on the
     butterfly body (radix 4, 2 last), none on another;
 11. the quadratic VDF over F_P63 at 2^20 rows, lde factor 8, FRI to
     degree 4 (fri_final_degree_plus_one = 4), native witness, the same;
 12. over F_STARK at lde factor 8, the same for the six-register instance
     with polyvariate cross-register terms at 2^20 rows (its witness a
     Python loop, timed) and the Repeated/Sparse one at 2^16 rows;
 14. (after phase 12, before phase 13) the memory-bounded forms (trees
     that keep only their root, leaves hashed in chunks, LDEs coset by
     coset, DEEP's domain points not kept; profiling.form_counts), with no
     earlier prover alive: 14a the main path's instance and witness at
     2^20 rows with every form forced (forced_forms) and the peak memory
     of every stage, its warm proof
     byte-equal to phase 5's and verified, more blake2s launches than
     phase 5's (the rebuilt trees), its peak beside phase 5's; 14b the
     quadratic VDF over F_STARK at 2^22 rows, lde 16, FRI to a constant,
     native witness, as phase 5, with the peak allocated and reserved
     memory of every stage, every form engaged, the prover's ops.tables
     with their bytes, and the most int32 elements handed to any kernel
     (below 2^31). Every earlier phase fails if a form engages in it;
 13. multi-device proving, Prover(mesh=...) over torch.distributed, the
     quadratic VDF over F_STARK at lde 16 from the native witness: 13a
     one rank over NCCL in this process at 2^20 rows, 13b two ranks
     sharing the card over gloo at 2^20 rows, 13c four ranks over gloo at
     2^16 rows (spawned processes; the kernels built above are loaded,
     not built again). The FRI ladders of 13b and 13c fold and commit the
     ranks' row blocks (parallel/fri.py). Every rank's proof must equal
     the single-device proof of the same witness (phase 5's at 2^20),
     verify, and have its tampered f_at_z_m[0] rejected; each rank's
     stage walls, peak device memory and collective calls, bytes and
     seconds per stage, the FRI stage's beside those of the earlier
     ladders on h1 and h2 gathered onto every rank (GATHERED_LADDERS), and
     rank 0's launches per
     kernel (set-up + cold prove), are printed. With ranks sharing one
     card, gloo carries every exchange through host memory: its seconds
     are not those of NVLink. 13d: two gloo ranks at 2^16 rows, a
     checkpointed prove and resumes after each of its four stages, every
     rank's proofs equal to the single-device proof (verified, a tampered
     copy rejected), each rank's peak in the checkpointed prove within
     one row block of its plain prove's; this process then resumes the
     directory the two ranks wrote on one device, byte-equal too.
 15. (after phase 8) the port's measuring command,
     hodor_tpu_torch/tools/bench.py, called in-process as a user runs it
     (BENCH_RUNS): the NTT at 2^16 and 2^20 over F_STARK, F_BLS and F_P63,
     at 2^20 under "fused" and "two_step", and held against the CPU at
     2^12; the quadratic VDF prove at 2^20 rows (3 warm proves) and 2^14;
     the FRI ladder pair at h1 = 2^24. Each run's JSON line is printed;
     it must be `correct` or `verified`, name this card, read no vs_sol
     above 1.05, and the run must launch the kernels of its path.
Phase 8 runs right after phase 5, whose prover it reuses and then frees;
every other phase lets its prover go when it returns. Every path of
phases 5-12, 14 and 15 zeroes the launch counts just before it runs and reads them
just after, names the kernels it must have launched and prints the
launches of each ntt_level body; the 2^20-row F_STARK paths must have run
the tensor-core body, phases 10 and 11 the butterfly body alone.

The line before the last holds the kernels' JSON record; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

from hodor_tpu_torch.tools.roofline import (OPS_BLAKE2S, bound_ms, ops_addsub, ops_fri_fold,
                                            ops_mont_mul, ops_ntt_level, ops_wide_reduce)

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG_ROWS = 20
LOG_ROWS_LEVEL_FORMS = 16
LOG_ROWS_WITNESS_FORMS = 14
LOG_ROWS_BATCH_SMALL = 18
LOG_ROWS_MESH_W4 = 16
LOG_ROWS_LARGE = 22

# name -> (source, the TPU kernel it replaces). mont_mul.cu has two
# entries, hodor_mont_mul and hodor_mont_pow (x^e in one launch, counted
# with mont_mul); ntt_level.cu has three bodies, "mma" (the contraction of
# csrc/byte_plane_mma.cuh on the int8 tensor cores), "butterfly" and "limb";
# dft_reduce.cu has two, "mma" and "dp4a", and the entry hodor_s8dot.
KERNEL_INFO = {
    "mont_mul": ("hodor_tpu_torch/csrc/mont_mul.cu", "hodor_tpu/field/pallas_kernels.py:283"),
    "addsub": ("hodor_tpu_torch/csrc/addsub.cu", "hodor_tpu/field/pallas_kernels.py:878"),
    "blake2s": ("hodor_tpu_torch/csrc/blake2s.cu", "hodor_tpu/field/pallas_kernels.py:787"),
    "ntt_level": ("hodor_tpu_torch/csrc/ntt_level.cu", "hodor_tpu/field/pallas_kernels.py:1384"),
    "fri_fold": ("hodor_tpu_torch/csrc/fri_fold.cu", "hodor_tpu/field/pallas_kernels.py:661"),
    "wide_reduce": ("hodor_tpu_torch/csrc/wide_reduce.cu",
                    "hodor_tpu/field/pallas_kernels.py:475"),
    "dft_reduce": ("hodor_tpu_torch/csrc/dft_reduce.cu",
                   "hodor_tpu/field/pallas_kernels.py:1097"),
}
MAIN_PATH_KERNELS = ("mont_mul", "addsub", "blake2s", "ntt_level", "fri_fold")


def level_bodies(size: int):
    """The bodies of ntt_level that take radix S by name at n16 = 16."""
    from hodor_tpu_torch.field import kernels as K

    return [b for b, sizes in (("mma", K.MMA_RADICES), ("butterfly", K.BUTTERFLY_RADICES),
                               ("limb", range(1, 129)))
            if size in sizes]


def nbytes(*tensors) -> int:
    """Bytes of the given tensors as stored (a broadcast operand counts
    once)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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

    from hodor_tpu_torch.field import F257, F_BLS, F_P63, F_STARK, LimbOps
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.merkle.blake2s import keyed_midstate
    from hodor_tpu_torch.ntt import matmul as M
    from hodor_tpu_torch.tools.launch_cost import device_time_ms, host_time_us

    field = F_STARK
    ops = LimbOps(field, dev)
    gen = torch.Generator().manual_seed(2024)
    n = 1 << 20
    records = {name: {"max_abs_err": 0, "cases": []} for name in K.KERNELS}

    def compare(name, case, kernel_fn, plain_fn, moved, n_ops, op_kind="int32", library_fn=None,
                reps=20, plain_reps=3, other_bodies=None):
        """moved: bytes the function must move (inputs once, outputs once);
        n_ops: its operations of kind op_kind on these inputs.
        other_bodies: {label: fn} of the kernel's other bodies, held to the
        same plain result and timed in the same turn."""
        other_bodies = other_bodies or {}
        want = plain_fn()
        for label, fn in [("", kernel_fn)] + list(other_bodies.items()):
            got = fn()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name}/{case} {label}: shape/dtype {got.shape} "
                                     f"{got.dtype} vs {want.shape} {want.dtype}")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
            if err != 0:
                raise AssertionError(f"{name}/{case} {label}: kernel differs from plain "
                                     f"version, max abs limb error {err}")
        moved += nbytes(got)
        del got, want
        ms = cuda_time_ms(kernel_fn, reps)
        device_ms, device_by, copies = device_time_ms(kernel_fn, reps)
        host_us = host_time_us(kernel_fn, max(reps, 50))
        other_ms = {label: cuda_time_ms(fn, reps) for label, fn in other_bodies.items()}
        plain_ms = cuda_time_ms(plain_fn, plain_reps)
        library_ms = None if library_fn is None else cuda_time_ms(library_fn, reps)
        bound, bound_by = bound_ms(moved, n_ops, op_kind)
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({
            "case": case, "ms": ms, "device_ms": device_ms, "device_by": device_by,
            "device_copies": copies, "host_us": host_us, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, **{f"{label}_body_ms": t for label, t in other_ms.items()}})
        log(f"kernel {name:11s} {case:36s} bit-equal  kernel {ms:9.3f} ms  device"
            f" {device_ms:9.4f} ms ({device_by}, {copies} copies)  host {host_us:8.1f} us"
            f"  plain {plain_ms:10.3f} ms"
            f"  bound {bound:7.3f} ms ({bound_by})"
            + "".join(f"  {label} body {t:7.3f} ms" for label, t in other_ms.items())
            + ("" if library_ms is None else f"  library {library_ms:7.3f} ms"))

    a = random_canonical(field, (n,), gen, dev)
    b = random_canonical(field, (n,), gen, dev)
    s = random_canonical(field, (), gen, dev)
    compare("mont_mul", "2^20 x 16 limbs",
            lambda: K.mont_mul(field, a, b), lambda: K.mont_mul_plain(field, a, b),
            nbytes(a, b), n * ops_mont_mul(16))
    compare("mont_mul", "2^20 x scalar (stride 0)",
            lambda: K.mont_mul(field, a, s), lambda: K.mont_mul_plain(field, a, s),
            nbytes(a, s), n * ops_mont_mul(16))
    # a view offset by one element (the flat body at another base), and a
    # transposed operand that collapses to no flat or grid form (general)
    compare("mont_mul", "2^20 - 1, views offset by one",
            lambda: K.mont_mul(field, a[1:], b[:-1]),
            lambda: K.mont_mul_plain(field, a[1:], b[:-1]),
            nbytes(a[1:], b[:-1]), (n - 1) * ops_mont_mul(16))
    at, bt = a.reshape(16, 1 << 16, 16).transpose(0, 1), b.reshape(1 << 16, 16, 16)
    compare("mont_mul", "(2^16,16) transposed view (general)",
            lambda: K.mont_mul(field, at, bt), lambda: K.mont_mul_plain(field, at, bt),
            nbytes(at, bt), n * ops_mont_mul(16))
    # the static power in one launch: e = p - 2 (Fermat inverse) on 1, 7
    # and 2^16 elements, against the loop of plain products and x * x^e = 1
    e_inv = field.p - 2
    pow_muls = e_inv.bit_length() - 1 + bin(e_inv).count("1") - 1
    for count in (1, 7, 1 << 16):
        xp = a[:count]
        before = K.launch_counts["mont_mul"]
        inv = K.mont_pow(field, xp, e_inv)
        if K.launch_counts["mont_mul"] != before + 1:
            raise AssertionError("mont_pow must be one launch")
        if not torch.equal(K.mont_mul(field, inv, xp), ops.one_m.expand(count, field.n16)):
            raise AssertionError(f"mont_pow: x * x^(p-2) != 1 on {count} elements")
        compare("mont_mul", f"mont_pow e=p-2 on {count} elements",
                lambda: K.mont_pow(field, xp, e_inv), lambda: K.mont_pow_plain(field, xp, e_inv),
                nbytes(xp), count * pow_muls * ops_mont_mul(16), reps=5, plain_reps=1)
    before = K.launch_counts["mont_mul"]
    if not torch.equal(ops.inv_fermat(s), K.mont_pow_plain(field, s, e_inv)):
        raise AssertionError("inv_fermat differs from its plain version")
    log(f"LimbOps.inv_fermat of one element: {K.launch_counts['mont_mul'] - before} launch "
        f"({pow_muls} products inside it)")
    if K.launch_counts["mont_mul"] != before + 1:
        raise AssertionError("inv_fermat must be one launch")
    for mode in ("add", "sub"):
        compare("addsub", f"{mode} 2^20 x 16 limbs",
                lambda: K.addsub(field, a, b, mode), lambda: K.addsub_plain(field, a, b, mode),
                nbytes(a, b), n * ops_addsub(16))
    compare("addsub", "sub 2^20 x scalar (stride 0)",
            lambda: K.addsub(field, a, s, "sub"), lambda: K.addsub_plain(field, a, s, "sub"),
            nbytes(a, s), n * ops_addsub(16))
    addsub_body_cases(dev, field, compare, a, b)
    del a, b
    # the LDE's coset shift at the f-LDE's width: coefficients (R, 1, T)
    # read with stride 0 over the factor axis, against powers (factor, T)
    coeffs = random_canonical(field, (2, 1, n // 2), gen, dev)
    pw = random_canonical(field, (16, n // 2), gen, dev)
    compare("mont_mul", "LDE shift (2,1,2^19) x (16,2^19)",
            lambda: K.mont_mul(field, coeffs, pw), lambda: K.mont_mul_plain(field, coeffs, pw),
            nbytes(coeffs, pw), 16 * n * ops_mont_mul(16), reps=5, plain_reps=1)
    del coeffs, pw

    mid = keyed_midstate()
    words = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, dtype=torch.int32).to(dev)
    compare("blake2s", "2^20 leaves (32 B)",
            lambda: K.blake2s(words, 32, mid), lambda: K.blake2s_plain(words, 32, mid),
            nbytes(words), n * OPS_BLAKE2S)
    nodes = words.reshape(n // 2, 16)
    compare("blake2s", "2^19 nodes (64 B)",
            lambda: K.blake2s(nodes, 64, mid), lambda: K.blake2s_plain(nodes, 64, mid),
            nbytes(nodes), n // 2 * OPS_BLAKE2S)
    del words, nodes

    # NTT levels at 2^20 elements: the four-step's first level (S = 128
    # over C columns, with its twiddle table and without), the terminal
    # level with the scalar 1/N, and the small radices
    x = random_canonical(field, (64, 128, 128), gen, dev)
    tw = random_canonical(field, (128, 128), gen, dev)

    def level_case(case, xv, size, inverse, t, reps=5):
        """One level shape: the body the wrapper picks against the plain
        version, and the other bodies that take the shape beside it."""
        w = M.dft_matrix(ops, size, inverse)
        body = K.ntt_level_body(field, size)
        planes = M.dft_matrix_planes(ops, size, inverse) if body == "mma" else None
        others = {b: (lambda b=b: K.ntt_level(field, xv, w, t, body=b))
                  for b in level_bodies(size) if b != body}
        before = dict(K.ntt_level_body_counts)
        compare("ntt_level", f"{case} [{body}]",
                lambda: K.ntt_level(field, xv, w, t, w_planes=planes),
                lambda: K.ntt_level_plain(field, xv, w, t),
                nbytes(xv, planes if planes is not None else w, t),
                xv.numel() // field.n16 * ops_ntt_level(size), "int8", reps=reps, plain_reps=1,
                other_bodies=others)
        if K.ntt_level_body_counts[body] == before[body]:
            raise AssertionError(f"ntt_level {case}: the {body} body did not launch")

    level_case("S=128 C=128 B=64 no twiddle", x, 128, False, None)
    level_case("S=128 C=128 B=64 twiddle table", x, 128, False, tw)
    # the first four-step level of a 2^20-point NTT (f-LDE, B = R x factor
    # of them) and of a 2^21-point one (g-LDE), with their own twiddle tables
    for log_n, bsz in ((20, 2), (21, 1)):
        cols = (1 << log_n) // 128
        xw = random_canonical(field, (bsz, 128, cols), gen, dev)
        level_case(f"S=128 C={cols} B={bsz} 2^{log_n} twiddles", xw, 128, False,
                   M.level_twiddles(ops, 1 << log_n, 128, False))
    del xw
    ninv = ops.const(field.inv(1 << 20))
    level_case("S=128 C=1 scalar 1/N (inverse)", x.reshape(n // 128, 128, 1, field.n16), 128,
               True, ninv)
    for size in (64, 32, 16, 8):
        level_case(f"S={size} C=1 B=2^20/{size}", x.reshape(n // size, size, 1, field.n16),
                   size, False, None, reps=20)
    # ragged edges of the tensor-core body's tile: C no multiple of 16 with
    # a batch boundary inside a tile, and a single column
    level_case("S=128 C=20 B=3 twiddle table", x[:3, :, :20].contiguous(), 128, False,
               tw[:, :20].contiguous(), reps=20)
    level_case("S=128 C=1 B=1", x[:1, :, :1].contiguous(), 128, False, None, reps=20)
    level_case("S=32 C=5 B=7 scalar", x[:7, :32, :5].contiguous(), 32, False, ninv, reps=20)

    # the FRI fold at the first rounds of the h1 and h2 ladders of a
    # 2^20-row prove (2^24 and 2^25 values), lo and hi the two halves of
    # one tensor, and at edge sizes
    two_inv = ops.two_inv_m
    c_scaled = ops.mul(random_canonical(field, (), gen, dev), two_inv)
    for half, label in ((1 << 23, "half=2^23"), (1 << 24, "half=2^24"), (1, "half=1"),
                        (3, "half=3")):
        values = random_canonical(field, (2 * half,), gen, dev)
        wv = random_canonical(field, (half,), gen, dev)
        lo, hi = values[:half], values[half:]
        big = half > 3
        compare("fri_fold", label,
                lambda: K.fri_fold(field, lo, hi, wv, c_scaled, two_inv),
                lambda: K.fri_fold_plain(field, lo, hi, wv, c_scaled, two_inv),
                nbytes(values, wv, c_scaled, two_inv), half * ops_fri_fold(16),
                reps=5 if big else 20, plain_reps=1 if big else 3)
        del values, wv, lo, hi
    # the fold with a lane axis, one launch for all lanes: the first h1
    # round of a 2^20-row batch of two proofs, and ragged lanes
    for lanes, half, label in ((2, 1 << 23, "B=2 half=2^23 (batch)"),
                               (3, 1001, "B=3 half=1001 (batch, ragged)")):
        values = random_canonical(field, (lanes, 2 * half), gen, dev)
        wv = random_canonical(field, (half,), gen, dev)
        cs = ops.mul(random_canonical(field, (lanes,), gen, dev), two_inv)
        lo, hi = values[:, :half], values[:, half:]
        before = K.launch_counts["fri_fold"]
        K.fri_fold(field, lo, hi, wv, cs, two_inv)
        if K.launch_counts["fri_fold"] != before + 1:
            raise AssertionError("the fold of all lanes must be one launch")
        big = half > 1001
        compare("fri_fold", label,
                lambda: K.fri_fold(field, lo, hi, wv, cs, two_inv),
                lambda: K.fri_fold_plain(field, lo, hi, wv, cs, two_inv),
                nbytes(values, wv, cs, two_inv), lanes * half * ops_fri_fold(16),
                reps=5 if big else 20, plain_reps=1 if big else 3)
        del values, wv, cs, lo, hi

    # the two-step level's reduce and the fused level at 2^20 elements:
    # the exact columns of x's byte-plane DFT (252 B per element), then
    # the same x through dft_reduce; no twiddle, a table, the scalar
    w_s8, w_sum = M.folded_dft_matrix(ops, 128, False)
    x_s8 = M.encode_s8(x).contiguous()
    columns = K.dft_columns_plain(w_s8, w_sum, x_s8)
    for label, t in (("no twiddle", None), ("twiddle table", tw), ("scalar twiddle", ninv)):
        compare("wide_reduce", f"2^20 elements radix 128 {label}",
                lambda: K.wide_reduce(field, columns, 128, t),
                lambda: K.wide_reduce_plain(field, columns, 128, t),
                nbytes(columns, t),
                n * (ops_wide_reduce(16) + (ops_mont_mul(16) if t is not None else 0)),
                reps=5, plain_reps=1)
    del columns
    def dft_case(case, fld, w8, wsum, xs8, size, t, reps=3):
        """One dft_reduce shape: the body the wrapper picks against the
        plain version (and against the plain walk of the columns with a
        running carry, the kernels' own order), and where that is the
        tensor-core body the __dp4a body too."""
        body = K.dft_reduce_body(fld, size)
        others = {"dp4a": lambda: K.dft_reduce(fld, w8, wsum, xs8, size, t, body="dp4a")} \
            if body == "mma" else {}
        if not torch.equal(K.dft_reduce_carry_plain(fld, w8, wsum, xs8, size, t),
                           K.dft_reduce_plain(fld, w8, wsum, xs8, size, t)):
            raise AssertionError(f"dft_reduce {case}: the two plain versions differ")
        before = dict(K.dft_reduce_body_counts)
        n_out = xs8.shape[0] * xs8.shape[1] * size
        compare("dft_reduce", f"{case} [{body}]",
                lambda: K.dft_reduce(fld, w8, wsum, xs8, size, t),
                lambda: K.dft_reduce_plain(fld, w8, wsum, xs8, size, t),
                nbytes(w8, wsum, xs8, t), n_out * 2 * w8.shape[0] * w8.shape[2], "int8",
                reps=reps, plain_reps=1, other_bodies=others)
        if K.dft_reduce_body_counts[body] == before[body]:
            raise AssertionError(f"dft_reduce {case}: the {body} body did not launch")

    for label, t in (("no twiddle", None), ("twiddle table", tw), ("scalar twiddle", ninv)):
        dft_case(f"(64,128,128) {label}", field, w_s8, w_sum, x_s8, 128, t)
    # ragged edges of the tensor-core body's 64 x 32 tile, the radix-32
    # level (a tile of 32 x 32), a 64-bit field (the __dp4a body alone) ...
    dft_case("(3,128,20) twiddle table", field, w_s8, w_sum, x_s8[:3, :20].contiguous(), 128,
             tw[:, :20].contiguous(), reps=10)
    dft_case("(1,128,1)", field, w_s8, w_sum, x_s8[:1, :1].contiguous(), 128, None, reps=10)
    w32_s8, w32_sum = M.folded_dft_matrix(ops, 32, False)
    dft_case("(7,32,5) scalar twiddle", field, w32_s8, w32_sum,
             M.encode_s8(x[:7, :32, :5].contiguous()).contiguous(), 32, ninv, reps=10)
    ops257 = LimbOps(F257, dev)
    x257 = torch.zeros((5, 128, 9, F257.n16), dtype=torch.int32)
    x257[..., 0] = torch.randint(0, F257.p, (5, 128, 9), generator=gen, dtype=torch.int32)
    x257 = x257.to(dev)
    w257_s8, w257_sum = M.folded_dft_matrix(ops257, 128, False)
    dft_case("F257 n16=4 (5,128,9)", F257, w257_s8, w257_sum,
             M.encode_s8(x257).contiguous(), 128, None, reps=10)
    # ... and a W that is no fold of anything: random int8 in the columns
    # below 60, so that t stays under the reduction's bound 128 p^2
    w_rand = torch.randint(-128, 128, tuple(w_s8.shape), generator=gen, dtype=torch.int8)
    w_rand[60:] = -128
    w_rand = w_rand.to(dev)
    w_rand_sum = (w_rand.to(torch.int32) + 128).sum(dim=-1, dtype=torch.int32)
    dft_case("(4,128,40) random int8 W, table", field, w_rand, w_rand_sum,
             x_s8[:4, :40].contiguous(), 128, tw[:, :40].contiguous(), reps=10)
    del x_s8, w_rand, w_rand_sum

    # the contraction alone: a bare launch's shape, and the product of the
    # fused level at 2^20 outputs (all 63 columns of W against all of x)
    for m_rows, depth, n_cols in ((128, 512, 128), (8064, 4096, 8192)):
        sa = torch.randint(-128, 128, (m_rows, depth), generator=gen, dtype=torch.int8).to(dev)
        sb = torch.randint(-128, 128, (depth, n_cols), generator=gen, dtype=torch.int8).to(dev)
        if m_rows == 128:
            want = (sa.cpu().to(torch.int32) @ sb.cpu().to(torch.int32)).to(dev)
            if not torch.equal(K.s8dot_plain(sa, sb), want):
                raise AssertionError("s8dot_plain differs from the int32 product")
            del want
        if not torch.equal(torch._int_mm(sa, sb), K.s8dot_plain(sa, sb)):
            raise AssertionError("torch._int_mm differs from s8dot_plain")
        compare("dft_reduce", f"s8dot ({m_rows},{depth}).({depth},{n_cols})",
                lambda: K.s8dot(sa, sb), lambda: K.s8dot_plain(sa, sb),
                nbytes(sa, sb), 2 * m_rows * depth * n_cols, "int8",
                library_fn=lambda: torch._int_mm(sa, sb), reps=10, plain_reps=2)
    del sa, sb

    for fld in (F_BLS, F_P63):
        kernel_cases_off_f_stark(dev, fld, gen, compare)

    # the three forms of the level on the same x and twiddle table
    forms = {}
    for impl in ("level", "two_step", "fused"):
        iops = LimbOps(field, dev, impl)
        forms[impl] = M.dft_level(iops, x, False, tw)
        ms = cuda_time_ms(lambda: M.dft_level(iops, x, False, tw), 3)
        records["ntt_level" if impl == "level" else
                "wide_reduce" if impl == "two_step" else "dft_reduce"]["cases"].append(
            {"case": f"whole level, form {impl!r}, (64,128,128) twiddle table", "ms": ms})
        log(f"level form {impl:9s} (64,128,128) twiddle table: {ms:9.3f} ms")
    for impl in ("two_step", "fused"):
        if not torch.equal(forms[impl], forms["level"]):
            raise AssertionError(f"level form {impl!r} differs from 'level'")
    log("level forms: two_step and fused bit-equal to level")
    return records


def addsub_body_cases(dev, field, compare, a, b) -> None:
    """addsub in each of its bodies at a field's width against the plain
    version, both modes: flat (p - 1 against p - 1, against 0 and 1 (the
    add wraps) and 0 and 1 against p - 1 (the subtraction borrows); 1, 3
    and 2^20 - 3 elements), grid (a (16, 2^16) period with a (2^16,) row,
    stride 0 over the 16) and general (a transposed view). a, b: (2^20, n16). Each case
    names the body it takes and fails if that body did not launch."""
    import torch

    from hodor_tpu_torch.field import kernels as K

    n16, n = field.n16, a.shape[0]
    tag = "" if field.name == "F_STARK" else f"{field.name} "
    worst, worst2 = worst_case(field, (n,), dev), worst_case(field, (n,), dev)
    zero_one = torch.zeros(n, n16, dtype=torch.int32, device=dev)
    zero_one[1::2, 0] = 1
    cases = (
        ("2^20, p-1 and p-1", worst, worst2),
        ("2^20, p-1 and 0/1", worst, zero_one),
        ("2^20, 0/1 and p-1", zero_one, worst),
        ("1 element, 0 and p-1", zero_one[:1], worst[1:2]),
        ("3 elements", a[:3], b[5:8]),
        ("2^20 - 3, views offset by 3", a[3:], b[:-3]),
        ("period (16,2^16) + (2^16,)", a.reshape(16, n // 16, n16), b[:n // 16]),
        ("(2^16,16) transposed view", a.reshape(16, n // 16, n16).transpose(0, 1),
         b.reshape(n // 16, 16, n16)),
    )
    for label, x, y in cases:
        body = K.addsub_body(x, y)
        count = max(x[..., 0].numel(), y[..., 0].numel())
        for mode in ("add", "sub"):
            before = K.addsub_body_counts[body]
            compare("addsub", f"{tag}{mode} {label} [{body}]",
                    lambda: K.addsub(field, x, y, mode),
                    lambda: K.addsub_plain(field, x, y, mode),
                    nbytes(x, y), count * ops_addsub(n16), plain_reps=1)
            if K.addsub_body_counts[body] == before:
                raise AssertionError(f"addsub {tag}{label}: the {body} body did not launch")
    for body in K.ADDSUB_BODIES:
        if not any(K.addsub_body(x, y) == body for _, x, y in cases):
            raise AssertionError(f"addsub at {field.name}: no case takes the {body} body")


def worst_case(field, shape, device):
    """Every element p - 1: the largest canonical value, in every limb."""
    import torch

    top = [((field.p - 1) >> (16 * i)) & 0xFFFF for i in range(field.n16)]
    return torch.tensor(top, dtype=torch.int32, device=device).expand(
        shape + (field.n16,)).contiguous()


def kernel_cases_off_f_stark(dev, field, gen, compare, log_n: int = 20):
    """Phase 3's cases at the widths phases 10 and 11 give the kernels:
    F_BLS (16 limbs) and F_P63 (4 limbs), both with a nearly full top word
    (R/p = 2.21 and 2.00), at 2^log_n elements. The NTT levels are those
    of the radix-4 recursion of a 2^20-point transform, (4^k, 4, 2^(18 - 2k))
    with the next level's twiddle table and the terminal level without one
    or with the scalar 1/N, and the radix-2 terminal level of an odd log
    size; the first and the terminal level at all x = p - 1 too, the
    largest sums the limb body sees.
    wide_reduce and the __dp4a body of dft_reduce at S = 4 are the other
    two level forms at these widths."""
    import torch

    from hodor_tpu_torch.field import LimbOps
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.ntt import matmul as M

    ops = LimbOps(field, dev)
    n16, tag, n = field.n16, field.name, 1 << log_n
    if M.max_radix(field) != 4:
        raise AssertionError(f"{tag}: max_radix {M.max_radix(field)}, expected 4")
    a = random_canonical(field, (n,), gen, dev)
    b = random_canonical(field, (n,), gen, dev)
    at, bt = a.reshape(16, n // 16, n16).transpose(0, 1), b.reshape(n // 16, 16, n16)
    coeffs = random_canonical(field, (2, 1, n // 2), gen, dev)
    pw = random_canonical(field, (16, n // 2), gen, dev)
    for label, x, y, count in ((f"2^{log_n}", a, b, n),
                               (f"LDE shift (2,1,2^{log_n - 1}) x (16,2^{log_n - 1})", coeffs, pw,
                                16 * n),
                               (f"(2^{log_n - 4},16) transposed view", at, bt, n)):
        compare("mont_mul", f"{tag} {label} [{K.mont_mul_body(x, y)}]",
                lambda: K.mont_mul(field, x, y), lambda: K.mont_mul_plain(field, x, y),
                nbytes(x, y), count * ops_mont_mul(n16), reps=5, plain_reps=1)
    del coeffs, pw, at, bt
    e_inv = field.p - 2
    pow_muls = e_inv.bit_length() - 1 + bin(e_inv).count("1") - 1
    for count in (1, n // 16):
        xp = a[:count]
        if not torch.equal(K.mont_mul(field, K.mont_pow(field, xp, e_inv), xp),
                           ops.one_m.expand(count, n16)):
            raise AssertionError(f"{tag} mont_pow: x * x^(p-2) != 1 on {count} elements")
        compare("mont_mul", f"{tag} mont_pow e=p-2 on {count} elements",
                lambda: K.mont_pow(field, xp, e_inv), lambda: K.mont_pow_plain(field, xp, e_inv),
                nbytes(xp), count * pow_muls * ops_mont_mul(n16), reps=5, plain_reps=1)
    for mode in ("add", "sub"):
        compare("addsub", f"{tag} {mode} 2^{log_n}",
                lambda: K.addsub(field, a, b, mode), lambda: K.addsub_plain(field, a, b, mode),
                nbytes(a, b), n * ops_addsub(n16))
    addsub_body_cases(dev, field, compare, a, b)
    c_scaled = ops.mul(random_canonical(field, (), gen, dev), ops.two_inv_m)
    wv = random_canonical(field, (n // 2,), gen, dev)
    lo, hi = a[:n // 2], a[n // 2:]
    compare("fri_fold", f"{tag} half=2^{log_n - 1}",
            lambda: K.fri_fold(field, lo, hi, wv, c_scaled, ops.two_inv_m),
            lambda: K.fri_fold_plain(field, lo, hi, wv, c_scaled, ops.two_inv_m),
            nbytes(a, wv, c_scaled, ops.two_inv_m), n // 2 * ops_fri_fold(n16), reps=5,
            plain_reps=1)
    # a ragged half (no multiple of a block) with every input p - 1, the
    # interleaved halves, and lanes
    worst = worst_case(field, (n,), dev)
    h = n // 2 - 3
    compare("fri_fold", f"{tag} half=2^{log_n - 1}-3, all p-1",
            lambda: K.fri_fold(field, worst[:h], worst[h:2 * h], worst[:h], worst[0], worst[1]),
            lambda: K.fri_fold_plain(field, worst[:h], worst[h:2 * h], worst[:h], worst[0],
                                     worst[1]),
            nbytes(worst[:3 * h], worst[0], worst[1]), h * ops_fri_fold(n16), reps=5,
            plain_reps=1)
    compare("fri_fold", f"{tag} half=2^{log_n - 1}, interleaved halves",
            lambda: K.fri_fold(field, a[0::2], a[1::2], wv, c_scaled, ops.two_inv_m),
            lambda: K.fri_fold_plain(field, a[0::2], a[1::2], wv, c_scaled, ops.two_inv_m),
            nbytes(a, wv, c_scaled, ops.two_inv_m), n // 2 * ops_fri_fold(n16), reps=5,
            plain_reps=1)
    del worst
    for lanes, half in ((3, 1001), (2, n // 4)):
        values = random_canonical(field, (lanes, 2 * half), gen, dev)
        wl = wv[:half]
        cs = ops.mul(random_canonical(field, (lanes,), gen, dev), ops.two_inv_m)
        lo, hi = values[:, :half], values[:, half:]
        before = K.launch_counts["fri_fold"]
        K.fri_fold(field, lo, hi, wl, cs, ops.two_inv_m)
        if K.launch_counts["fri_fold"] != before + 1:
            raise AssertionError(f"{tag}: the fold of all lanes must be one launch")
        compare("fri_fold", f"{tag} B={lanes} half={half} (batch)",
                lambda: K.fri_fold(field, lo, hi, wl, cs, ops.two_inv_m),
                lambda: K.fri_fold_plain(field, lo, hi, wl, cs, ops.two_inv_m),
                nbytes(values, wl, cs, ops.two_inv_m), lanes * half * ops_fri_fold(n16),
                reps=5, plain_reps=1)
    del a, b, wv, lo, hi, values

    ninv = ops.const(field.inv(n))
    quarter, half = n // 4, n // 2
    levels = [(4, 4 ** k, quarter // 4 ** k, "table") for k in (0, 3, 6)
              if 4 ** k < quarter]
    levels += [(4, 1, quarter, None), (4, quarter, 1, None), (4, quarter, 1, "scalar"),
               (2, half, 1, None), (2, half, 1, "scalar"), (2, 1, half, "table")]
    for size, bsz, cols, tw_kind in levels:
        w = M.dft_matrix(ops, size, False)
        tw = {"table": random_canonical(field, (size, cols), gen, dev), "scalar": ninv,
              None: None}[tw_kind]
        worst = (bsz, cols) in ((1, quarter), (half, 1))
        for inputs in ("random", "all p-1") if worst else ("random",):
            x = random_canonical(field, (bsz, size, cols), gen, dev) if inputs == "random" \
                else worst_case(field, (bsz, size, cols), dev)
            body = K.ntt_level_body(field, size)
            if body != "butterfly":
                raise AssertionError(f"{tag} S={size}: ntt_level takes the {body} body")
            before = K.ntt_level_body_counts[body]
            compare("ntt_level", f"{tag} S={size} B={bsz} C={cols} {tw_kind or 'no'} twiddle, "
                    f"{inputs} [{body}]",
                    lambda: K.ntt_level(field, x, w, tw),
                    lambda: K.ntt_level_plain(field, x, w, tw),
                    nbytes(x, w, tw), n * ops_ntt_level(size, n16), "int8", reps=20,
                    plain_reps=1,
                    other_bodies={"limb": lambda: K.ntt_level(field, x, w, tw, body="limb")})
            if K.ntt_level_body_counts[body] == before:
                raise AssertionError(f"{tag} S={size}: the {body} body did not launch")
    # the other two level forms at S = 4: the two-step reduce of the exact
    # columns, and dft_reduce (its __dp4a body: S < 32)
    x = random_canonical(field, (1, 4, quarter), gen, dev)
    tw = random_canonical(field, (4, quarter), gen, dev)
    w_s8, w_sum = M.folded_dft_matrix(ops, 4, False)
    x_s8 = M.encode_s8(x).contiguous()
    columns = K.dft_columns_plain(w_s8, w_sum, x_s8)
    compare("wide_reduce", f"{tag} S=4 (1,4,2^{log_n - 2}) twiddle table",
            lambda: K.wide_reduce(field, columns, 4, tw),
            lambda: K.wide_reduce_plain(field, columns, 4, tw),
            nbytes(columns, tw), n * (ops_wide_reduce(n16) + ops_mont_mul(n16)), reps=5,
            plain_reps=1)
    del columns
    if K.dft_reduce_body(field, 4) != "dp4a":
        raise AssertionError(f"{tag}: dft_reduce at S=4 must take the __dp4a body")
    compare("dft_reduce", f"{tag} S=4 (1,4,2^{log_n - 2}) twiddle table [dp4a]",
            lambda: K.dft_reduce(field, w_s8, w_sum, x_s8, 4, tw),
            lambda: K.dft_reduce_plain(field, w_s8, w_sum, x_s8, 4, tw),
            nbytes(w_s8, w_sum, x_s8, tw), n * 2 * w_s8.shape[0] * w_s8.shape[2], "int8",
            reps=5, plain_reps=1)


def phase_goldens(dev) -> None:
    import tempfile

    from hodor_tpu_torch.air import Fibonacci, TestTraceSystem
    from hodor_tpu_torch.field import F257, F_STARK
    from hodor_tpu_torch.models import VDF, CubicVDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.tools import gen_golden
    from hodor_tpu_torch.verifier import Verifier

    golden = os.path.join(ROOT, "tests", "golden")

    def check(name, witness, props, field, ntt_impl="level"):
        t0 = time.perf_counter()
        prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev,
                        ntt_impl=ntt_impl)
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
        log(f"golden {name} (ntt_impl={ntt_impl}): proof bytes and challenge log equal, "
            f"verified (set-up + prove {wall:.2f} s)")

    fib = Fibonacci(F257, final_b=5, at_step=3)
    tracer = TestTraceSystem(F257)
    fib.trace(tracer)
    tracer.calculate_witness(1, 1, 3)
    witness, props = tracer.into_arp()
    check("fib_f257", witness, props, F257)
    witness, props = VDF(F_STARK, 1, 2, 31).into_arp()
    for impl in ("level", "two_step", "fused"):
        check("vdf_fstark_t32", witness, props, F_STARK, impl)
    witness, props = CubicVDF(F_STARK, 1, 1, 31).into_arp()
    check("cubic_vdf_fstark_t32", witness, props, F_STARK)

    # the port's writer of the goldens, on the card, into a directory of its own
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out:
        if gen_golden.main(["gen_golden", "--out", out]) != 0:
            raise AssertionError("tools/gen_golden.py failed on the card")
        names = sorted(os.listdir(golden))
        if sorted(os.listdir(out)) != names:
            raise AssertionError(f"tools/gen_golden.py wrote {sorted(os.listdir(out))}, "
                                 f"not {names}")
        for name in names:
            with open(os.path.join(out, name), "rb") as a, \
                    open(os.path.join(golden, name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"tools/gen_golden.py: {name} differs from the golden")
    log(f"golden: tools/gen_golden.py on the card wrote {len(names)} files, each byte-equal "
        "to tests/golden/")


# phase 15: tools/bench.py's runs (argv, the kernels the run must launch)
BENCH_RUNS = (
    [(["--mode", "ntt", "--log-n", str(n), "--field", f], ("ntt_level",))
     for f in ("F_STARK", "F_BLS", "F_P63") for n in (16, 20)]
    + [(["--mode", "ntt", "--log-n", "20", "--impl", "fused"], ("dft_reduce",)),
       (["--mode", "ntt", "--log-n", "20", "--impl", "two_step"], ("wide_reduce",)),
       (["--mode", "ntt", "--log-n", "12", "--check"], ("ntt_level",)),
       (["--mode", "prove", "--log-rows", "20", "--reps", "3"], MAIN_PATH_KERNELS),
       (["--mode", "prove", "--log-rows", "14"], MAIN_PATH_KERNELS),
       (["--mode", "fri", "--log-h1", "24"], ("mont_mul", "ntt_level", "blake2s", "fri_fold"))]
)


def phase_bench(dev) -> dict:
    """Phase 15: the port's measuring command, tools/bench.py, called
    in-process on the card as a user would run it; each run's JSON line is
    printed. A run fails the phase unless it returns 0 with its line
    `correct` or `verified`, on this card, with no vs_sol above 1.05 (the
    NTT's share of the H100's bound), and launches the kernels its path
    runs. Returns {path: launch counts}."""
    import io

    import torch

    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.tools import bench

    kind = torch.cuda.get_device_name(0)
    paths = {}
    for argv, kernels in BENCH_RUNS:
        label = "bench " + " ".join(argv)
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["bench", *argv])
        counts = dict(K.launch_counts)
        out = buf.getvalue().splitlines()
        log(out[-1] if out else f"{label}: no line")
        if rc != 0 or len(out) != 1:
            raise AssertionError(f"{label}: returned {rc} with {len(out)} lines")
        line = json.loads(out[0])
        if not (line.get("correct") is True or line.get("verified") is True):
            raise AssertionError(f"{label}: the line is neither correct nor verified")
        if line["device"] != kind:
            raise AssertionError(f"{label}: ran on {line['device']!r}, not {kind!r}")
        if "vs_sol" in line and not line["vs_sol"] <= 1.05:
            raise AssertionError(f"{label}: vs_sol {line['vs_sol']} above 1.05 of the bound")
        require_launched(label, counts, kernels)
        log(f"{label}: {time.perf_counter() - t0:.2f} s, launches {json.dumps(counts)}, "
            f"ntt_level by body {json.dumps(K.ntt_level_body_counts)}")
        paths[label] = counts
    return paths


def require_launched(path: str, counts, names) -> None:
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched on this path: {missing}")


def phase_at_size(dev, label: str, field, into_arp, native: bool = True, lde_factor: int = 16,
                  fri_final_degree_plus_one: int = 1, ntt_bodies=("mma", "butterfly", "limb"),
                  forms: bool = False, per_stage: bool = False):
    """Set-up, cold and warm prove, verify and a tampered proof for one
    instance: into_arp() gives (witness, props); native: whether the
    witness must come from the native chain as a packed array; ntt_bodies:
    the ntt_level bodies the path may run, the first of which it must run;
    forms: whether the memory-bounded forms (profiling.form_counts) may
    engage, else the phase fails if one does; per_stage: the peak memory
    of every stage of both proves, allocated and reserved, printed as the
    stage ends (tools/memory_profile.stage_peaks), and the proves' peaks
    taken from them. Returns the launch counts of the set-up + cold prove
    + verify, their ntt_level bodies, and the warm prove: {"counts",
    "ntt_bodies", "mont_mul_bodies" (its launches), "addsub_bodies" (those
    of the set-up + cold prove + verify), "proof" (its bytes,
    serialized before the tamper), "wall", "peaks" (cold, warm, GiB),
    "forms" (cold, warm form counts), "stages" (cold, warm stage records,
    with per_stage), "prover", "witness", "props"}."""
    import numpy as np
    import torch

    from hodor_tpu_torch import profiling
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.tools.memory_profile import stage_peaks
    from hodor_tpu_torch.verifier import Verifier

    def prove_once():
        """(proof, wall, peak allocated, peak reserved, stage records)."""
        profiling.reset_form_counts()
        records = []
        t0 = time.perf_counter()
        if per_stage:
            with stage_peaks(records, lambda line: log(f"{label}:{line}")):
                proof = prover.prove(witness)
        else:
            proof = prover.prove(witness)
        wall = time.perf_counter() - t0
        if per_stage:
            return (proof, wall, max(r[1] for r in records), max(r[2] for r in records),
                    records)
        return proof, wall, torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved(), []

    def check_forms(run: str):
        engaged = dict(profiling.form_counts)
        log(f"{label}: memory-bounded forms in the {run} prove: {json.dumps(engaged)}")
        if not forms and any(engaged.values()):
            raise AssertionError(f"{label}: a memory-bounded form engaged at this size: {engaged}")
        return engaged

    t0 = time.perf_counter()
    witness, props = into_arp()
    rows = f"2^{props.num_rows.bit_length() - 1} rows"
    packed = isinstance(witness, np.ndarray)
    if native and not packed:
        raise AssertionError(f"{label}: the {rows} witness must come from the native chain as a "
                             "packed array")
    log(f"{label}: {field.name}, {rows}, {props.num_registers} registers, lde {lde_factor}, "
        f"fri_final_degree_plus_one {fri_final_degree_plus_one}, witness "
        f"({f'native chain, {witness.dtype} {witness.shape}' if packed else 'Python lists'}) "
        f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prover = Prover(props.clone(), lde_factor=lde_factor,
                    fri_final_degree_plus_one=fri_final_degree_plus_one, device=dev)
    torch.cuda.synchronize()
    log(f"{label}: prover set-up {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    proof, cold, peak_cold, reserved_cold, stages_cold = prove_once()
    forms_cold = check_forms("cold")
    verifier = Verifier(props, lde_factor=lde_factor)
    t0 = time.perf_counter()
    if not verifier.verify(proof):
        raise AssertionError(f"{label}: the verifier rejects the {rows} proof")
    verify_s = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    bodies = dict(K.ntt_level_body_counts)
    addsub_bodies = dict(K.addsub_body_counts)
    log(f"{label}: cold prove {cold:.3f} s (stage walls: {prover.last_timings.to_json()})")
    log(f"{label}: verify {verify_s:.3f} s -> accepted")
    log(f"{label}: launches in set-up + cold prove + verify: {json.dumps(counts)}")
    log(f"{label}: ntt_level launches by body: {json.dumps(bodies)}")
    log(f"{label}: addsub launches by body: {json.dumps(addsub_bodies)}, mont_mul by body: "
        f"{json.dumps(K.mont_mul_body_counts)}")
    if sum(addsub_bodies.values()) != counts["addsub"]:
        raise AssertionError(f"{label}: addsub launches by body {addsub_bodies} do not sum to "
                             f"{counts['addsub']}")
    if bodies[ntt_bodies[0]] == 0 or sum(bodies[b] for b in ntt_bodies) != counts["ntt_level"]:
        raise AssertionError(f"{label}: the path must run the {ntt_bodies[0]!r} body of ntt_level "
                             f"and no body but {ntt_bodies}, got {bodies} of "
                             f"{counts['ntt_level']}")

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    proof, warm, peak_warm, reserved_warm, stages_warm = prove_once()
    forms_warm = check_forms("warm")
    warm_run = {"counts": dict(K.launch_counts), "ntt_bodies": dict(K.ntt_level_body_counts),
                "mont_mul_bodies": dict(K.mont_mul_body_counts), "addsub_bodies": addsub_bodies,
                "proof": serialize_proof(proof, field), "wall": warm,
                "peaks": (peak_cold / 2**30, peak_warm / 2**30),
                "forms": (forms_cold, forms_warm), "stages": (stages_cold, stages_warm),
                "prover": prover, "witness": witness, "props": props}
    log(f"{label}: warm prove {warm:.3f} s (stage walls: {prover.last_timings.to_json()})")
    log(f"{label}: launches in the warm prove: {json.dumps(warm_run['counts'])}, ntt_level by "
        f"body {json.dumps(warm_run['ntt_bodies'])}")
    log(f"{label}: peak device memory cold {peak_cold / 2**30:.3f} GiB, "
        f"warm {peak_warm / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); reserved cold "
        f"{reserved_cold / 2**30:.3f} GiB, warm {reserved_warm / 2**30:.3f} GiB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_dev = prover.arp.encode_witness(witness)
    torch.cuda.synchronize()
    log(f"{label}: encode_witness alone {time.perf_counter() - t0:.4f} s "
        f"-> {tuple(w_dev.shape)} on {w_dev.device}")
    del w_dev
    if not verifier.verify(proof):
        raise AssertionError(f"{label}: the verifier rejects the warm proof")
    proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % field.p
    if verifier.verify(proof):
        raise AssertionError(f"{label}: the verifier accepts a tampered f_at_z_m[0]")
    log(f"{label}: warm proof accepted; tampered f_at_z_m[0] rejected")
    require_launched(label, counts, MAIN_PATH_KERNELS)
    return counts, bodies, warm_run


def six_registers(field, rows: int):
    """tests/test_multi_register.py's instance at `rows` rows: a0[i+1] =
    a0[i] + 1 and a_r[i+1] = a_r[i] a_{r-1}[i] for r = 1..5 (polyvariate,
    across registers), dense; boundaries at row 0 and a5's last row. The
    witness is a host loop of 5 products a row."""
    from hodor_tpu_torch import air
    from hodor_tpu_torch.arp import InstanceProperties

    p = field.p
    regs = [air.Register.Register(i) for i in range(6)]

    def at(r, steps):
        return air.UnivariateTerm(1, regs[r], air.StepDifference.Steps(steps), 1)

    c = air.Constraint(density=air.DenseConstraint())
    c += at(0, 1)
    c -= at(0, 0)
    c -= 1
    constraints = [c]
    for r in range(1, 6):
        c = air.Constraint(density=air.DenseConstraint())
        c += at(r, 1)
        c -= air.PolyvariateTerm(coeff=1, terms=[at(r, 0), at(r - 1, 0)], total_degree=2)
        constraints.append(c)
    cols = [[0] * rows for _ in range(6)]
    cols[0][0] = 2
    for r in range(1, 6):
        cols[r][0] = r + 1
    for i in range(rows - 1):
        cols[0][i + 1] = (cols[0][i] + 1) % p
        for r in range(1, 6):
            cols[r][i + 1] = cols[r][i] * cols[r - 1][i] % p
    boundary = [air.BoundaryConstraint(regs[r], 0, cols[r][0]) for r in range(6)]
    boundary.append(air.BoundaryConstraint(regs[5], rows - 1, cols[5][-1]))
    return cols, InstanceProperties(num_rows=rows, num_registers=6, constraints=constraints,
                                    boundary_constraints=boundary, field=field)


def repeated_sparse(field, rows: int, seed: int = 5):
    """tests/test_density_repeated_sparse.py's instance at `rows` rows: a[i+1]
    = a[i]^2 + 1 at the even rows (Repeated(0, 1, 2)), b[i+1] = 3 b[i] at
    rows 1 and 4 (Sparse). Its first 8 rows are the 8-row fixture's; every
    value that no rule fixes is drawn from `seed`."""
    import random

    from hodor_tpu_torch import air
    from hodor_tpu_torch.arp import InstanceProperties

    p = field.p
    rng = random.Random(seed)
    r0, r1 = air.Register.Register(0), air.Register.Register(1)
    c0 = air.Constraint(density=air.RepeatedConstraint(start_at=0, span=1, interval=2))
    c0 += air.UnivariateTerm(1, r0, air.StepDifference.Steps(1), 1)
    c0 -= air.UnivariateTerm(1, r0, air.StepDifference.Steps(0), 1).pow(2)
    c0 -= 1
    c1 = air.Constraint(density=air.SparseConstraint(rows=(1, 4)))
    c1 += air.UnivariateTerm(1, r1, air.StepDifference.Steps(1), 1)
    c1 -= air.UnivariateTerm(1, r1, air.StepDifference.Steps(0), 1).scaled(3)
    a = [3, 0, 7, 0, 2, 0, 9, 0] + [rng.randrange(p) for _ in range(rows - 8)]
    for i in range(0, rows - 1, 2):
        a[i + 1] = (a[i] * a[i] + 1) % p
    b = [2, 5, 0, 7, 4, 0, 8, 6] + [rng.randrange(p) for _ in range(rows - 8)]
    b[2] = 3 * b[1] % p
    b[5] = 3 * b[4] % p
    boundary = [air.BoundaryConstraint(r0, 0, a[0]), air.BoundaryConstraint(r1, 0, b[0])]
    return [a, b], InstanceProperties(num_rows=rows, num_registers=2, constraints=[c0, c1],
                                      boundary_constraints=boundary, field=field)


def phase_witness_forms(dev) -> None:
    """A 2^LOG_ROWS_WITNESS_FORMS-row quadratic VDF proved from the Python
    chain's lists and from the native chain's packed array: equal proof
    bytes, both verified."""
    import numpy as np

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    steps = (1 << LOG_ROWS_WITNESS_FORMS) - 1
    proofs, seconds = {}, {}
    for form in ("python", "native"):
        t0 = time.perf_counter()
        witness, props = VDF(F_STARK, 1, 2, steps, witness=form).into_arp()
        seconds[form] = time.perf_counter() - t0
        if isinstance(witness, np.ndarray) != (form == "native"):
            raise AssertionError(f"witness form {form!r} gave a {type(witness).__name__}")
        prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
        proof = prover.prove(witness)
        if not Verifier(props, lde_factor=16).verify(proof):
            raise AssertionError(f"witness form {form!r}: the verifier rejects the proof")
        proofs[form] = serialize_proof(proof, F_STARK)
    if proofs["python"] != proofs["native"]:
        raise AssertionError("the proofs from the Python and the native witness differ")
    log(f"witness forms: 2^{LOG_ROWS_WITNESS_FORMS} rows, proofs from the Python chain "
        f"({seconds['python']:.3f} s) and the native chain ({seconds['native']:.3f} s) are equal "
        f"({len(proofs['python'])} bytes), both verified")


def phase_level_forms(dev):
    """The quadratic VDF at 2^LOG_ROWS_LEVEL_FORMS rows under each form of
    the NTT level. Returns {form: launch counts of set-up + prove}."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.verifier import Verifier

    witness, props = VDF(F_STARK, 1, 2, (1 << LOG_ROWS_LEVEL_FORMS) - 1,
                         witness="python").into_arp()
    verifier = Verifier(props, lde_factor=16)
    must = {"level": ("ntt_level",), "two_step": ("wide_reduce",), "fused": ("dft_reduce",)}
    proofs, counts, fused_bodies = {}, {}, {}
    for impl in ("level", "two_step", "fused"):
        torch.cuda.empty_cache()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev,
                        ntt_impl=impl)
        proof = prover.prove(witness)
        wall = time.perf_counter() - t0
        counts[impl] = dict(K.launch_counts)
        bodies = dict(K.ntt_level_body_counts)
        if not verifier.verify(proof):
            raise AssertionError(f"level form {impl!r}: the verifier rejects the proof")
        proofs[impl] = serialize_proof(proof, F_STARK)
        label = f"level forms: 2^{LOG_ROWS_LEVEL_FORMS} rows under {impl!r}"
        log(f"{label}: set-up + prove {wall:.3f} s, verified "
            f"(stage walls: {prover.last_timings.to_json()})")
        log(f"{label}: launches {json.dumps(counts[impl])}, ntt_level by body "
            f"{json.dumps(bodies)}")
        require_launched(label, counts[impl], must[impl] + ("mont_mul", "addsub", "blake2s",
                                                            "fri_fold"))
        others = [k for kk, v in must.items() if kk != impl for k in v]
        if any(counts[impl][k] for k in others):
            raise AssertionError(f"{label}: another form's kernel launched: {counts[impl]}")
        if impl == "fused":
            fused_bodies = dict(K.dft_reduce_body_counts)
            log(f"{label}: dft_reduce launches by body {json.dumps(fused_bodies)}")
            if fused_bodies["mma"] == 0 or \
                    fused_bodies["mma"] + fused_bodies["dp4a"] != counts[impl]["dft_reduce"]:
                raise AssertionError(f"{label}: the fused prove must run the tensor-core body "
                                     f"of dft_reduce, got {fused_bodies}")
    if not (proofs["level"] == proofs["two_step"] == proofs["fused"]):
        raise AssertionError("the proofs under the three level forms differ")
    log(f"level forms: the three serialized proofs are equal ({len(proofs['level'])} bytes)")
    return counts, fused_bodies


def rejected(verifier, proof) -> bool:
    """Whether the verifier refuses a proof (False or an exception)."""
    try:
        return not verifier.verify(proof)
    except Exception:
        return True


def phase_batch(dev, single, lanes_b: int = 2):
    """Phase 8: prove_batch at 2^LOG_ROWS rows on B lanes, lane 0 phase
    5's witness, lane 1 the start (3, 5) under phase 5's instance. Returns
    the warm batch's launch counts."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.verifier import Verifier

    label = f"batch 2^{LOG_ROWS} B={lanes_b}"
    prover = single["prover"]
    witness1, _ = VDF(F_STARK, 3, 5, (1 << LOG_ROWS) - 1).into_arp()
    witnesses = [single["witness"], witness1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lane1_single = serialize_proof(prover.prove(witness1), F_STARK)
    walls, peaks = {}, {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        proofs = prover.prove_batch(witnesses)
        walls[run] = time.perf_counter() - t0
        peaks[run] = torch.cuda.max_memory_allocated()
        counts, ntt_bodies = dict(K.launch_counts), dict(K.ntt_level_body_counts)
        mul_bodies = dict(K.mont_mul_body_counts)
        log(f"{label}: {run} batch {walls[run]:.3f} s for {lanes_b} proofs "
            f"(stage walls: {prover.last_timings.to_json()})")
    log(f"{label}: peak device memory cold {peaks['cold'] / 2**30:.3f} GiB, warm "
        f"{peaks['warm'] / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); one warm prove "
        f"{single['wall']:.3f} s")
    blobs = [serialize_proof(p, F_STARK) for p in proofs]
    if blobs[0] != single["proof"]:
        raise AssertionError(f"{label}: lane 0 differs from phase 5's proof")
    if blobs[1] != lane1_single:
        raise AssertionError(f"{label}: lane 1 differs from its sequential prove")
    verifier = Verifier(single["props"], lde_factor=16)
    if not verifier.verify(proofs[0]):
        raise AssertionError(f"{label}: the verifier rejects lane 0")
    if not rejected(verifier, proofs[1]):
        raise AssertionError(f"{label}: the verifier accepts lane 1 (another start)")
    log(f"{label}: lane 0 equals phase 5's proof ({len(blobs[0])} bytes), lane 1 its sequential "
        "prove; lane 0 accepted, lane 1 rejected")
    log(f"{label}: launches per kernel, warm batch vs warm single prove: " + ", ".join(
        f"{k} {counts[k]} vs {single['counts'][k]}" for k in K.KERNELS))
    log(f"{label}: mont_mul launches by body, warm batch {json.dumps(mul_bodies)} vs warm single "
        f"{json.dumps(single['mont_mul_bodies'])}")
    log(f"{label}: ntt_level launches by body {json.dumps(ntt_bodies)}")
    for name in ("fri_fold", "blake2s"):
        if counts[name] != single["counts"][name]:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, one prove "
                                 f"{single['counts'][name]}")
    times = [k for k in K.KERNELS if single["counts"][k] and
             counts[k] >= lanes_b * single["counts"][k]]
    if times:
        raise AssertionError(f"{label}: {times} launched B times as often as in one prove")
    if ntt_bodies["mma"] == 0:
        raise AssertionError(f"{label}: the tensor-core body of ntt_level did not run")
    # the body of G's and DEEP's products by a per-lane challenge (B, 1, L)
    # at this size: G's constraint values (B, D, L) and DEEP's (B, N_f, L)
    n16 = F_STARK.n16
    challenge = torch.zeros((lanes_b, 1, n16), dtype=torch.int32, device=dev)
    for what, rows in (("G", 2 << LOG_ROWS), ("DEEP", 16 << LOG_ROWS)):
        values = torch.empty((lanes_b, rows, n16), dtype=torch.int32, device=dev)
        log(f"{label}: {what} product ({lanes_b}, {rows}, {n16}) x ({lanes_b}, 1, {n16}) takes "
            f"the {K.mont_mul_body(values, challenge)!r} body of mont_mul")
        del values
    require_launched(label, counts, MAIN_PATH_KERNELS)
    return counts


def phase_batch_small(dev, log_rows: int, lanes_b: int = 4):
    """Phase 8b: B distinct lanes at 2^log_rows rows, each byte-equal to
    its sequential prove; the warm batch's wall per proof beside a warm
    single prove. Returns the warm batch's launch counts."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover

    label = f"batch 2^{log_rows} B={lanes_b}"
    starts = [(1, 2), (3, 5), (2, 9), (7, 11)][:lanes_b]
    arps = [VDF(F_STARK, c0, c1, (1 << log_rows) - 1).into_arp() for c0, c1 in starts]
    witnesses = [w for w, _ in arps]
    prover = Prover(arps[0][1].clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
    singles, single_walls = [], []
    for w in [witnesses[0]] + witnesses:  # the first prove warms the prover up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = serialize_proof(prover.prove(w), F_STARK)
        single_walls.append(time.perf_counter() - t0)
        singles.append(blob)
    singles = singles[1:]
    if len(set(singles)) != lanes_b:
        raise AssertionError(f"{label}: the lanes' proofs are not distinct")
    walls = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        proofs = prover.prove_batch(witnesses)
        walls[run] = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        log(f"{label}: {run} batch {walls[run]:.3f} s (stage walls: "
            f"{prover.last_timings.to_json()})")
    if [serialize_proof(p, F_STARK) for p in proofs] != singles:
        raise AssertionError(f"{label}: a lane differs from its sequential prove")
    warm_single = min(single_walls[1:])
    log(f"{label}: every lane equals its sequential prove; warm batch {walls['warm'] / lanes_b:.4f} "
        f"s per proof, warm single prove {warm_single:.4f} s "
        f"(ratio {warm_single / (walls['warm'] / lanes_b):.2f})")
    log(f"{label}: launches of the warm batch {json.dumps(counts)}")
    require_launched(label, counts, MAIN_PATH_KERNELS)
    return counts


def phase_support(dev, log_rows: int) -> None:
    """Phase 9: checkpoint/resume, from_config and the host Blake2s library
    at 2^log_rows rows."""
    import shutil
    import tempfile

    from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
    from hodor_tpu_torch.config import ProofSystemConfig
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.merkle.tree import MerkleTree
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.utils import native

    label = f"support 2^{log_rows}"
    witness, props = VDF(F_STARK, 1, 2, (1 << log_rows) - 1).into_arp()
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
    baseline = serialize_proof(prover.prove(witness), F_STARK)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        full = os.path.join(tmp, "full")
        t0 = time.perf_counter()
        if serialize_proof(prover.prove(witness, checkpoint_dir=full), F_STARK) != baseline:
            raise AssertionError(f"{label}: the checkpointed prove differs")
        saved = time.perf_counter() - t0
        walls = []
        for keep in range(1, len(STAGES) + 1):
            ckdir = os.path.join(tmp, f"keep{keep}")
            shutil.copytree(full, ckdir)
            for stage in STAGES[keep:]:
                for path in ProveCheckpoint(ckdir)._paths(stage):
                    os.remove(path)
            t0 = time.perf_counter()
            blob = serialize_proof(prover.prove(witness, checkpoint_dir=ckdir), F_STARK)
            walls.append(time.perf_counter() - t0)
            resumed = sum(r.name.endswith("(resumed)") for r in prover.last_timings.records)
            if blob != baseline or resumed != keep:
                raise AssertionError(f"{label}: the resume after {STAGES[keep - 1]} differs "
                                     f"({resumed} stages resumed)")
    log(f"{label}: checkpointed prove {saved:.3f} s; resumes after " + ", ".join(
        f"{s} {w:.3f} s" for s, w in zip(STAGES, walls)) + ": all byte-equal to a plain prove")
    by_config = Prover.from_config(props.clone(), ProofSystemConfig(), device=dev)
    if serialize_proof(by_config.prove(witness), F_STARK) != baseline:
        raise AssertionError(f"{label}: from_config gives other proof bytes")
    log(f"{label}: Prover.from_config(ProofSystemConfig()) byte-equal")
    # the host library's tree against the device tree over 2^log_rows leaves
    ops = prover.ops
    values = ops.encode([pow(5, i, F_STARK.p) for i in range(1 << log_rows)])
    tree = MerkleTree.create(values, F_STARK)
    leaves = b"".join(F_STARK.raw_repr_le(int(v)).ljust(32, b"\x00")
                      for v in ops.decode(values))
    t0 = time.perf_counter()
    _, nodes = native.build_tree(leaves, 1 << log_rows)
    host_s = time.perf_counter() - t0
    if nodes[32:64] != tree.get_root():
        raise AssertionError(f"{label}: the host library's root differs from the device tree's")
    log(f"{label}: host Blake2s library tree over 2^{log_rows} leaves {host_s:.3f} s, root equal "
        "to the device tree's")


def forced_forms():
    """Phase 14a's setting of every memory-bounded form's constant: the
    two size thresholds at 1, so that every tree drops and every LDE runs
    coset by coset; the two chunk sizes at 2^20 rows, the least that keeps a 2^20-row prove's launches
    in the thousands (each LDE-sized array in 16 to 32 chunks). Returns
    [(module, name, value)]."""
    import hodor_tpu_torch.ali.instance as ali_instance
    import hodor_tpu_torch.merkle.blake2s as blake2s_module
    import hodor_tpu_torch.merkle.tree as tree_module
    import hodor_tpu_torch.ntt as ntt_module

    return [(tree_module, "TREE_DROP_MIN", 1), (ntt_module, "LDE_SEQUENTIAL_MIN", 1),
            (blake2s_module, "HASH_CHUNK", 1 << 20), (ali_instance, "XS_KEEP_MAX", 1 << 20)]


def phase_forms_forced(dev, main_proof: bytes, main_counts, main_peaks):
    """Phase 14a: the main path's instance and witness at 2^LOG_ROWS rows
    with every memory-bounded form forced (forced_forms), with per-stage
    peaks: the warm proof byte-equal to phase 5's, verified
    (phase_at_size), every form engaged, more blake2s launches than phase
    5 (the rebuilt trees), and the peak beside phase 5's. Returns the
    launch counts of set-up + cold prove + verify."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF

    label = f"forms forced 2^{LOG_ROWS}"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    forced = forced_forms()
    plain = [(module, name, getattr(module, name)) for module, name, _ in forced]
    for module, name, value in forced:
        setattr(module, name, value)
    counts, _, warm = phase_at_size(dev, label, F_STARK,
                                    VDF(F_STARK, 1, 2, (1 << LOG_ROWS) - 1).into_arp, forms=True,
                                    per_stage=True)
    for module, name, value in plain:
        setattr(module, name, value)
    if warm["proof"] != main_proof:
        raise AssertionError(f"{label}: the warm proof differs from phase 5's")
    idle = [k for run in warm["forms"] for k, v in run.items() if v == 0]
    if idle:
        raise AssertionError(f"{label}: forms that did not engage: {idle}")
    if counts["blake2s"] <= main_counts["blake2s"]:
        raise AssertionError(f"{label}: blake2s launched {counts['blake2s']} times, no more than "
                             f"phase 5's {main_counts['blake2s']}: no tree was rebuilt")
    log(f"{label}: warm proof equals phase 5's ({len(main_proof)} bytes); blake2s launches "
        f"{counts['blake2s']} against phase 5's {main_counts['blake2s']}; peak device memory "
        f"cold {warm['peaks'][0]:.3f} / warm {warm['peaks'][1]:.3f} GiB against phase 5's "
        f"{main_peaks[0]:.3f} / {main_peaks[1]:.3f} GiB")
    log(f"{label}: phase {time.perf_counter() - t0:.2f} s")
    return counts


@contextlib.contextmanager
def largest_operands(names):
    """While active, each kernel wrapper of field/kernels.py named in
    `names` records in sizes[name] the most int32 elements of any tensor
    it was given or returned. Yields sizes."""
    import torch

    from hodor_tpu_torch.field import kernels as K

    sizes = dict.fromkeys(names, 0)
    plain = {name: getattr(K, name) for name in names}

    def watched(name):
        def call(*args, **kwargs):
            out = plain[name](*args, **kwargs)
            sizes[name] = max([sizes[name], out.numel()] + [
                a.numel() for a in args if isinstance(a, torch.Tensor)])
            return out
        return call

    for name in names:
        setattr(K, name, watched(name))
    yield sizes
    for name in names:
        setattr(K, name, plain[name])


def phase_large(dev):
    """Phase 14b: the quadratic VDF over F_STARK at 2^LOG_ROWS_LARGE rows,
    lde 16, FRI to a constant, the native witness, through phase_at_size
    with per-stage peaks: every memory-bounded form must engage; the keys
    of the prover's ops.tables with their bytes; the most int32 elements
    any kernel was handed, which must stay below 2^31 (phase 3 holds no
    kernel at that size). Returns the launch counts of set-up + cold prove
    + verify."""
    import torch

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.tools.memory_profile import table_bytes

    label = f"large 2^{LOG_ROWS_LARGE}"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with largest_operands(("mont_mul", "mont_pow", "addsub", "blake2s", "ntt_level",
                           "fri_fold")) as sizes:
        counts, _, warm = phase_at_size(
            dev, label, F_STARK, VDF(F_STARK, 1, 2, (1 << LOG_ROWS_LARGE) - 1).into_arp,
            forms=True, per_stage=True)
    idle = [k for run in warm["forms"] for k, v in run.items() if v == 0]
    if idle:
        raise AssertionError(f"{label}: forms that did not engage: {idle}")
    for run, records in zip(("cold", "warm"), warm["stages"]):
        log(f"{label}: {run} stages (name, peak allocated, peak reserved, allocated at the end, "
            f"GiB): " + json.dumps([(r[0], *(round(b / 2**30, 3) for b in r[1:]))
                                      for r in records]))
    tables = table_bytes(warm["prover"].ops.tables)
    log(f"{label}: ops.tables after the proves, {sum(b for _, b in tables) / 2**30:.3f} GiB: "
        + ", ".join(f"{key} {b}" for key, b in tables))
    log(f"{label}: most int32 elements handed to each kernel: {json.dumps(sizes)}")
    if max(sizes.values()) >= 1 << 31:
        raise AssertionError(f"{label}: a kernel was handed 2^31 int32 elements or more, a size "
                             f"phase 3 does not hold: {sizes}")
    summary = {"warm_s": warm["wall"], "peak_gib": warm["peaks"], "forms": warm["forms"]}
    log(f"{label}: summary {json.dumps(summary)}")
    log(f"{label}: phase {time.perf_counter() - t0:.2f} s")
    return counts


def phase_mesh_rank(mesh, device, log_rows: int) -> dict:
    """One rank of phase 13: the quadratic VDF at 2^log_rows rows, lde 16,
    under `mesh`: set-up and a cold prove (launch counts, peak), then a
    warm prove (stage walls, collectives per stage, peak). Returns the
    warm proof's bytes and the figures. The first launch loads the kernel
    library the parent built."""
    import torch

    from hodor_tpu_torch import parallel as par
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover

    witness, props = VDF(F_STARK, 1, 2, (1 << log_rows) - 1).into_arp()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    par.reset_collective_counts()
    t0 = time.perf_counter()
    prover = Prover(props, lde_factor=16, fri_final_degree_plus_one=1, device=device, mesh=mesh)
    cold_proof = serialize_proof(prover.prove(witness), F_STARK)
    cold = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    ntt_bodies = dict(K.ntt_level_body_counts)
    peak_cold = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = serialize_proof(prover.prove(witness), F_STARK)
    warm = time.perf_counter() - t0
    if proof != cold_proof:
        raise AssertionError("the warm and the cold proof differ")
    return {"rank": mesh.get_local_rank(), "device": str(device), "proof": proof,
            "setup_cold_s": cold, "warm_s": warm, "stages": prover.last_timings.to_json(),
            "fri_s": prover.last_timings.as_dict()["fri_h1+h2"],
            "exchanges": prover.last_exchanges, "counts": counts,
            "ntt_bodies": ntt_bodies,
            "peak_gib": (peak_cold / 2**30, torch.cuda.max_memory_allocated() / 2**30)}


def phase_mesh_checkpoint_rank(mesh, device, log_rows: int, root: str) -> dict:
    """One rank of phase 13d: the quadratic VDF at 2^log_rows rows under
    `mesh`: a cold prove, a warm one (peak), a checkpointed one into
    root/full (wall, peak), then resumes of copies of that directory cut
    after each stage (rank 0 makes them). Returns the proofs' bytes, walls,
    peaks and the stages each resume took from the directory."""
    import shutil

    import torch
    import torch.distributed as dist

    from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import serialize_proof
    from hodor_tpu_torch.prover import Prover

    witness, props = VDF(F_STARK, 1, 2, (1 << log_rows) - 1).into_arp()
    prover = Prover(props, lde_factor=16, fri_final_degree_plus_one=1, device=device, mesh=mesh)
    prover.prove(witness)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = serialize_proof(prover.prove(witness), F_STARK)
    peak_plain = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = os.path.join(root, "full")
    t0 = time.perf_counter()
    saved = serialize_proof(prover.prove(witness, checkpoint_dir=full), F_STARK)
    saved_s = time.perf_counter() - t0
    peak_saved = torch.cuda.max_memory_allocated()
    rank = mesh.get_local_rank()
    if rank == 0:
        for keep in range(1, len(STAGES) + 1):
            shutil.copytree(full, os.path.join(root, f"keep{keep}"))
            for stage in STAGES[keep:]:
                for path in ProveCheckpoint(os.path.join(root, f"keep{keep}"))._paths(stage):
                    os.remove(path)
    dist.barrier(group=mesh.get_group())
    resumes = {}
    for keep, stage in enumerate(STAGES, 1):
        t0 = time.perf_counter()
        blob = serialize_proof(prover.prove(witness, checkpoint_dir=os.path.join(
            root, f"keep{keep}")), F_STARK)
        resumes[stage] = (blob, time.perf_counter() - t0,
                          sum(r.name.endswith("(resumed)") for r in prover.last_timings.records))
    return {"rank": rank, "plain": plain, "saved": saved, "saved_s": saved_s,
            "resumes": resumes, "peak_bytes": (peak_plain, peak_saved)}


def phase_mesh_checkpoint(dev, log_rows: int, want: bytes) -> None:
    """Phase 13d: two gloo ranks at 2^log_rows rows checkpoint and resume
    (phase_mesh_checkpoint_rank); every proof must be `want`, the
    single-device proof, and the peak of each rank's checkpointed prove at
    most one row block (of the largest saved array) above its plain
    prove's; then this process resumes the ranks' directory on one device
    after DEEP and after FRI."""
    import shutil
    import tempfile

    import numpy as np

    from hodor_tpu_torch.checkpoint import STAGES, ProveCheckpoint
    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.tools.dryrun import run_ranks
    from hodor_tpu_torch.verifier import Verifier

    w = 2
    label = f"13d mesh W={w} gloo one card 2^{log_rows}, checkpoint/resume"
    witness, props = VDF(F_STARK, 1, 2, (1 << log_rows) - 1).into_arp()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        t0 = time.perf_counter()
        ranks = run_ranks(phase_mesh_checkpoint_rank, w, (log_rows, root), device=dev.type,
                          backend="gloo", timeout=300)
        log(f"{label}: phase {time.perf_counter() - t0:.2f} s (spawn included)")
        arrays = [ProveCheckpoint(os.path.join(root, "full")).load(s)[0] for s in STAGES]
        block = max(a.nbytes for stage in arrays for a in stage.values()) // w
        for res in ranks:
            r = res["rank"]
            proofs = [res["plain"], res["saved"]] + [b for b, _, _ in res["resumes"].values()]
            if any(p != want for p in proofs):
                raise AssertionError(f"{label}: rank {r}: a proof differs from the single-device "
                                     "proof")
            if [n for _, _, n in res["resumes"].values()] != list(range(1, len(STAGES) + 1)):
                raise AssertionError(f"{label}: rank {r}: a resume took other stages from the "
                                     "directory")
            peak_plain, peak_saved = res["peak_bytes"]
            log(f"{label}: rank {r}: checkpointed prove {res['saved_s']:.3f} s; resumes after "
                + ", ".join(f"{s} {t:.3f} s" for s, (_, t, _) in res["resumes"].items())
                + f"; peak device memory plain {peak_plain / 2**30:.3f} GiB, checkpointed "
                f"{peak_saved / 2**30:.3f} GiB (one block of the largest saved array "
                f"{block / 2**30:.3f} GiB)")
            if peak_saved > peak_plain + block:
                raise AssertionError(f"{label}: rank {r}'s checkpointed prove peaks more than one "
                                     "block above its plain prove")
        verifier = Verifier(props, lde_factor=16)
        proof = deserialize_proof(want, F_STARK)
        if not verifier.verify(proof):
            raise AssertionError(f"{label}: the verifier rejects the proof")
        proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % F_STARK.p
        if not rejected(verifier, proof):
            raise AssertionError(f"{label}: the verifier accepts a tampered f_at_z_m[0]")
        prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device=dev)
        walls = []
        for keep in (3, 4):
            ckdir = os.path.join(root, f"one_device{keep}")
            shutil.copytree(os.path.join(root, f"keep{keep}"), ckdir)
            t0 = time.perf_counter()
            if serialize_proof(prover.prove(witness, checkpoint_dir=ckdir), F_STARK) != want:
                raise AssertionError(f"{label}: the one-device resume after {STAGES[keep - 1]} "
                                     "differs")
            walls.append(time.perf_counter() - t0)
        log(f"{label}: every rank's plain, checkpointed and four resumed proofs equal the "
            f"single-device proof, verified, tampered f_at_z_m[0] rejected; the directory "
            f"resumed on one device after deep {walls[0]:.3f} s and after fri {walls[1]:.3f} s, "
            f"byte-equal ({int(np.sum([a.nbytes for st in arrays for a in st.values()]))} bytes "
            "saved)")


# phases 13b and 13c when the FRI ladders ran on h1 and h2 gathered onto
# every rank (H100 80GB HBM3 at 700.00 W, as PERF.md records them)
GATHERED_LADDERS = {"13b": "FRI stage 2.988 s of rank 0's 6.117 s warm prove, 2.655 s of it the gather "
                   "of h1 and h2, 1.5 GiB a rank; peak 22.29-22.35 GiB a rank",
            "13c": "peak 1.217-1.223 GiB a rank"}


def phase_mesh(dev, single_proof: bytes) -> dict:
    """Phase 13: 13a W = 1 over NCCL in this process, 13b W = 2 and 13c
    W = 4 over gloo in spawned ranks sharing the card, 13d checkpoints
    under W = 2. Returns rank 0's launch counts per path."""
    import torch
    import torch.distributed as dist

    from hodor_tpu_torch.field import F_STARK
    from hodor_tpu_torch.models import VDF
    from hodor_tpu_torch.parallel import make_mesh
    from hodor_tpu_torch.parallel.multihost import init_multihost
    from hodor_tpu_torch.proof_io import deserialize_proof, serialize_proof
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.tools.dryrun import free_tcp_address, run_ranks
    from hodor_tpu_torch.verifier import Verifier

    def check(label, ranks, want, props):
        for res in ranks:
            log(f"{label}: rank {res['rank']} ({res['device']}): set-up + cold prove "
                f"{res['setup_cold_s']:.3f} s, warm prove {res['warm_s']:.3f} s (stage walls: "
                f"{res['stages']}); peak device memory cold {res['peak_gib'][0]:.3f} GiB, warm "
                f"{res['peak_gib'][1]:.3f} GiB")
            log(f"{label}: rank {res['rank']} collectives per stage of the warm prove: "
                f"{json.dumps(res['exchanges'])}")
            fri = res["exchanges"].get("fri_h1+h2", {})
            log(f"{label}: rank {res['rank']} FRI stage {res['fri_s']:.3f} s of the warm prove, "
                + ", ".join(f"{kind} {c['calls']} calls {c['bytes'] / 2**30:.4f} GiB "
                            f"{c['seconds']:.3f} s" for kind, c in fri.items())
                + f"; peak {res['peak_gib'][1]:.3f} GiB (gathered ladders: "
                f"{GATHERED_LADDERS.get(label[:3], 'not measured')})")
            if res["proof"] != want:
                raise AssertionError(f"{label}: rank {res['rank']}'s proof differs from the "
                                     "single-device proof of the same witness")
        verifier = Verifier(props, lde_factor=16)
        proof = deserialize_proof(ranks[0]["proof"], F_STARK)
        if not verifier.verify(proof):
            raise AssertionError(f"{label}: the verifier rejects the mesh proof")
        proof.f_at_z_m[0] = (proof.f_at_z_m[0] + 1) % F_STARK.p
        if not rejected(verifier, proof):
            raise AssertionError(f"{label}: the verifier accepts a tampered f_at_z_m[0]")
        r0 = ranks[0]
        log(f"{label}: every rank's proof equals the single-device proof ({len(want)} bytes), "
            "verified; tampered f_at_z_m[0] rejected")
        log(f"{label}: rank 0 launches in set-up + cold prove: {json.dumps(r0['counts'])}, "
            f"ntt_level by body {json.dumps(r0['ntt_bodies'])}")
        require_launched(label, r0["counts"], MAIN_PATH_KERNELS)
        return r0["counts"]

    paths = {}
    _, props = VDF(F_STARK, 1, 2, (1 << LOG_ROWS) - 1).into_arp()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    label = f"13a mesh W=1 NCCL 2^{LOG_ROWS}"
    t0 = time.perf_counter()
    init_multihost(free_tcp_address(), 1, 0, "nccl", dev)
    try:
        res = phase_mesh_rank(make_mesh(1, dev), dev, LOG_ROWS)
    finally:
        dist.destroy_process_group()
    log(f"{label}: phase {time.perf_counter() - t0:.2f} s")
    paths[label] = check(label, [res], single_proof, props)
    del res
    torch.cuda.empty_cache()

    label = f"13b mesh W=2 gloo one card 2^{LOG_ROWS}"
    t0 = time.perf_counter()
    ranks = run_ranks(phase_mesh_rank, 2, (LOG_ROWS,), device=dev.type, backend="gloo",
                      timeout=420)
    log(f"{label}: phase {time.perf_counter() - t0:.2f} s (spawn included)")
    paths[label] = check(label, ranks, single_proof, props)

    label = f"13c mesh W=4 gloo one card 2^{LOG_ROWS_MESH_W4}"
    witness, props = VDF(F_STARK, 1, 2, (1 << LOG_ROWS_MESH_W4) - 1).into_arp()
    want = serialize_proof(Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1,
                                  device=dev).prove(witness), F_STARK)
    t0 = time.perf_counter()
    ranks = run_ranks(phase_mesh_rank, 4, (LOG_ROWS_MESH_W4,), device=dev.type, backend="gloo",
                      timeout=300)
    log(f"{label}: phase {time.perf_counter() - t0:.2f} s (spawn included)")
    paths[label] = check(label, ranks, want, props)

    phase_mesh_checkpoint(dev, LOG_ROWS_MESH_W4, want)
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hodor_tpu_torch.field import F_BLS, F_P63, F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF, CubicVDF
    from hodor_tpu_torch.utils.native import build_host_library

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
    t0 = time.perf_counter()
    host_lib = build_host_library()
    log(f"build: host library {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(host_lib, ROOT)}")

    records = phase_kernels(dev)
    phase_goldens(dev)
    rows = (1 << LOG_ROWS) - 1
    main_counts, main_bodies, main_warm = phase_at_size(dev, "main path, quadratic VDF", F_STARK,
                                                        VDF(F_STARK, 1, 2, rows).into_arp)
    paths = {"quadratic VDF 2^20 (main path)": main_counts}
    log(f"main path: mont_mul launches of set-up + cold prove + verify {main_counts['mont_mul']} "
        "(a static power, inv_fermat among them, is one launch)")
    # phase 8 reuses phase 5's prover, then lets it go, so that no later
    # peak counts its tables
    paths[f"quadratic VDF 2^{LOG_ROWS} prove_batch B=2 (warm)"] = phase_batch(dev, main_warm)
    main_proof, main_peaks = main_warm["proof"], main_warm["peaks"]
    main_addsub_bodies = main_warm["addsub_bodies"]
    del main_warm
    # phase 15 after phase 5's prover is let go: the bench builds its own
    paths.update(phase_bench(dev))
    phase_witness_forms(dev)
    paths["cubic VDF 2^20"] = phase_at_size(dev, "cubic VDF", F_STARK,
                                            CubicVDF(F_STARK, 1, 1, rows).into_arp)[0]
    form_counts, fused_bodies = phase_level_forms(dev)
    for impl, counts in form_counts.items():
        paths[f"quadratic VDF 2^{LOG_ROWS_LEVEL_FORMS}, level form {impl}"] = counts
    paths[f"quadratic VDF 2^{LOG_ROWS_BATCH_SMALL} prove_batch B=4 (warm)"] = \
        phase_batch_small(dev, LOG_ROWS_BATCH_SMALL)
    phase_support(dev, LOG_ROWS_LEVEL_FORMS)
    # phases 10-12: off the goldens' ground; each phase's prover is let go
    # when it returns
    off_ground = (
        ("F_BLS quadratic VDF 2^20, lde 16", F_BLS, VDF(F_BLS, 1, 2, rows).into_arp,
         dict(ntt_bodies=("butterfly",))),
        ("F_P63 quadratic VDF 2^20, lde 8, FRI to degree 4", F_P63,
         VDF(F_P63, 1, 2, rows).into_arp,
         dict(lde_factor=8, fri_final_degree_plus_one=4, ntt_bodies=("butterfly",))),
        ("six registers 2^20, lde 8", F_STARK, lambda: six_registers(F_STARK, 1 << LOG_ROWS),
         dict(native=False, lde_factor=8)),
        (f"Repeated/Sparse 2^{LOG_ROWS_LEVEL_FORMS}, lde 8", F_STARK,
         lambda: repeated_sparse(F_STARK, 1 << LOG_ROWS_LEVEL_FORMS),
         dict(native=False, lde_factor=8)),
    )
    off_ground_bodies = {}
    for label, fld, into_arp, options in off_ground:
        paths[label], off_ground_bodies[label], warm = phase_at_size(dev, label, fld, into_arp,
                                                                     **options)
        summary = {"warm_s": warm["wall"], "peak_gib": warm["peaks"],
                   "warm_launches": warm["counts"], "proof_bytes": len(warm["proof"])}
        log(f"{label}: summary {json.dumps(summary)}")
        del warm
    # phase 14: the memory-bounded forms, with no earlier prover alive
    paths[f"quadratic VDF 2^{LOG_ROWS}, every memory-bounded form forced"] = \
        phase_forms_forced(dev, main_proof, main_counts, main_peaks)
    paths[f"quadratic VDF 2^{LOG_ROWS_LARGE}"] = phase_large(dev)
    torch.cuda.empty_cache()
    paths.update(phase_mesh(dev, main_proof))
    never = [k for k in K.KERNELS if not any(c[k] for c in paths.values())]
    if never:
        raise AssertionError(f"kernels no path launched: {never}")

    # a kernel's launches: those of the main path where it runs there,
    # else those of the first path that runs it
    kernels = []
    for name in K.KERNELS:
        source, replaces = KERNEL_INFO[name]
        rec = records[name]
        first = rec["cases"][0]
        path = next(p for p, c in paths.items() if c[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path][name], "launches_on": path,
            "max_abs_err": rec["max_abs_err"],
            "ms": first["ms"], "device_ms": first["device_ms"], "device_by": first["device_by"],
            "host_us": first["host_us"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "cases": rec["cases"],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
        })
        if name == "ntt_level":
            kernels[-1]["launches_by_body"] = main_bodies
            kernels[-1]["launches_by_body_off_ground"] = off_ground_bodies
            kernels[-1]["contraction"] = "hodor_tpu_torch/csrc/byte_plane_mma.cuh"
            kernels[-1]["entries"] = ["hodor_ntt_level_mma", "hodor_ntt_level_butterfly",
                                      "hodor_ntt_level"]
        if name == "dft_reduce":
            kernels[-1]["launches_by_body"] = fused_bodies
            kernels[-1]["entries"] = ["hodor_dft_reduce_mma", "hodor_dft_reduce", "hodor_s8dot"]
        if name == "mont_mul":
            kernels[-1]["entries"] = ["hodor_mont_mul", "hodor_mont_pow"]
        if name == "addsub":
            kernels[-1]["launches_by_body"] = main_addsub_bodies
    log(f"device: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
