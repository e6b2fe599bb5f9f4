"""What a call of an elementwise kernel wrapper costs the card and what it
costs the host, measured apart, on one GPU.

    python hodor_tpu_torch/tools/launch_cost.py [ROOT [ONLY]]

ROOT is the checkout whose `hodor_tpu_torch` is measured (default: the
one this file belongs to), so that an older commit unpacked with
`git archive` beside this one is measured by the same code on the same
card: run ROOT = older, newer, newer, older in one process per run.
ONLY keeps the cases whose kernel and case name contain it (F_P63, say).

For each case of `chip_smoke.py` phase 3 that runs `mont_mul`, `addsub`
or `fri_fold` (at F_STARK's, F_BLS's and F_P63's widths, 2^20 elements;
the fold at half 2^23 and 2^24; and F_P63 at its prove's 2^24
elements), and for a whole FRI round's fold as ROOT's ladder makes it
(`fri round`: `fold_pair`, which draws the challenge from the last root
and reads the ladder's twiddle tables), one JSON line: `host_us`, the
host clock over `HOST_REPS` calls with no synchronisation, divided by
the calls (the median of `HOST_BATCHES` such batches, `host_time_us`);
`device_ms`, the device time of one call, from `DEVICE_REPS` calls
captured in a CUDA graph and replayed between two CUDA events, the calls
cycling over `copies` copies of their operands so that none reads them
from L2 (`device_time_ms`). The card's name and power limit come first.
Needs a CUDA device.

`chip_smoke.py` phase 3 takes `device_time_ms` and `host_time_us` from
here for every kernel case.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import torch

HOST_REPS = 200
HOST_BATCHES = 5
DEVICE_REPS = 20
L2_SWEEP_BYTES = 256 << 20
"""Bytes of operands the timed calls cycle through: five times the H100's
50 MB L2, so that no call finds its operands left in L2 by the calls
before it (2^20 four-limb elements are 16 MiB an array)."""
MAX_COPIES = 64


def _storage_copy(t: torch.Tensor, memo: dict) -> torch.Tensor:
    """t viewed, with its shape, strides and offset, on a copy of its
    storage; views of one storage share one copy (memo)."""
    storage = t.untyped_storage()
    if storage.data_ptr() not in memo:
        memo[storage.data_ptr()] = storage.clone()
    copy = memo[storage.data_ptr()]
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        copy, t.storage_offset(), t.size(), t.stride())


def input_copies(fn, sweep_bytes: int = L2_SWEEP_BYTES, max_copies: int = MAX_COPIES):
    """[fn, fn_1, ..., fn_{k-1}]: fn and k - 1 copies of it, each with every
    tensor that fn's closure cells and defaults hold replaced by the same
    view of a copy of its storage, k the least number of copies whose
    storages hold `sweep_bytes` (at most `max_copies`). Tensors that fn
    reaches otherwise (an object's attributes, a container) are shared by
    all the copies."""
    cells = fn.__closure__ or ()
    held = [c.cell_contents for c in cells if _filled(c)] + list(fn.__defaults__ or ())
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in held if isinstance(t, torch.Tensor)}
    footprint = sum(storages.values())
    if footprint == 0:
        return [fn]
    copies = max(1, min(max_copies, -(-sweep_bytes // footprint)))

    def swap(value, memo):
        return _storage_copy(value, memo) if isinstance(value, torch.Tensor) else value

    out = [fn]
    for _ in range(copies - 1):
        memo = {}
        closure = tuple(types.CellType(swap(c.cell_contents, memo)) if _filled(c)
                        else types.CellType() for c in cells) or None
        defaults = tuple(swap(v, memo) for v in fn.__defaults__ or ()) or None
        out.append(types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, defaults,
                                      closure))
    return out


def _filled(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def device_time_ms(fn, reps: int = DEVICE_REPS):
    """(milliseconds of device time per call of fn, "graph" or "profiler",
    the number of operand copies): `reps` calls, and at least one on each
    copy of `input_copies(fn)`, cycling over the copies so that each call
    reads its operands from device memory and not from L2, captured in a
    CUDA graph whose replay is timed with CUDA events after one replay to
    warm up. Where the calls cannot be captured, the sum of the device
    intervals of the same calls under torch.profiler."""
    fns = input_copies(fn)
    calls = [fns[i % len(fns)] for i in range(max(reps, len(fns)))]
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for f in calls:
                f()
    except RuntimeError:
        del graph
        torch.cuda.synchronize()
        return _profiled_ms(calls), "profiler", len(fns)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms, copies = start.elapsed_time(end) / len(calls), len(fns)
    del graph, fns, calls
    return ms, "graph", copies


def _profiled_ms(calls) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in calls:
            f()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / len(calls)


def host_time_us(fn, reps: int = HOST_REPS, batches: int = HOST_BATCHES) -> float:
    """Microseconds of host time per call of fn: the host clock over
    `reps` calls that nothing synchronises, divided by `reps`, after one
    call to warm up; the median of `batches` such batches, the card
    synchronised between them. One batch lasts a few milliseconds, so a
    single preemption of the process on a shared host would move its mean
    by tens of percent; the median does not follow it."""
    import statistics
    import time

    fn()
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def _canonical(field, shape, gen, device):
    """Seeded uniform limbs with the top limb cut below p's top bit."""
    limbs = torch.randint(0, 1 << 16, shape + (field.n16,), generator=gen, dtype=torch.int32)
    limbs[..., -1] &= (1 << (field.num_bits - 1 - 16 * (field.n16 - 1))) - 1
    return limbs.to(device)


def _fold_case(K, fri, field, ops, lo, hi, gen, dev):
    """A call of ROOT's fold wrapper on lo and hi as round 0 of their
    ladder: the call draws c from a root and w from the ladder's tables."""
    root = _root(gen, dev)
    tw = fri.fold_twiddles(ops, (2 * lo.shape[-2] - 1).bit_length())
    return lambda: K.fri_fold(field, lo, hi, root, tw, 1)


def _round_case(fri, ops, lo, hi, gen, dev):
    """A whole round's fold as ROOT's ladder makes it from the last root:
    `fold_pair` alone, its twiddle tables built first."""
    root = _root(gen, dev)
    log_n = (2 * lo.shape[-2] - 1).bit_length()
    fri.fold_twiddles(ops, log_n)
    return lambda: fri.fold_pair(ops, lo, hi, root, 1, log_n)


def _root(gen, dev):
    return torch.randint(-1 << 31, 1 << 31, (8,), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)


def cases(dev):
    """(kernel, case, fn): phase 3's elementwise cases at 2^20 elements, the
    fold's at half 1, 2^23 and 2^24 (F_STARK), F_P63's at 2^24 elements
    and half 2^23, and a whole FRI round's fold at half 2^23 and 2^24."""
    from hodor_tpu_torch.field import F_BLS, F_P63, F_STARK, LimbOps
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.fri import fri

    gen = torch.Generator().manual_seed(2024)
    n = 1 << 20
    out = []
    for field in (F_STARK, F_BLS, F_P63):
        ops = LimbOps(field, dev)
        a, b = _canonical(field, (n,), gen, dev), _canonical(field, (n,), gen, dev)
        s = _canonical(field, (), gen, dev)
        coeffs = _canonical(field, (2, 1, n // 2), gen, dev)
        pw = _canonical(field, (16, n // 2), gen, dev)
        tag = "" if field is F_STARK else f"{field.name} "
        out += [
            ("mont_mul", f"{tag}2^20", lambda f=field, x=a, y=b: K.mont_mul(f, x, y)),
            ("mont_mul", f"{tag}2^20 x scalar (stride 0)",
             lambda f=field, x=a, y=s: K.mont_mul(f, x, y)),
            ("mont_mul", f"{tag}LDE shift (2,1,2^19) x (16,2^19)",
             lambda f=field, x=coeffs, y=pw: K.mont_mul(f, x, y)),
            ("addsub", f"{tag}add 2^20", lambda f=field, x=a, y=b: K.addsub(f, x, y, "add")),
            ("addsub", f"{tag}sub 2^20", lambda f=field, x=a, y=b: K.addsub(f, x, y, "sub")),
            ("addsub", f"{tag}sub 2^20 x scalar (stride 0)",
             lambda f=field, x=a, y=s: K.addsub(f, x, y, "sub")),
            ("fri_fold", f"{tag}half=2^19",
             _fold_case(K, fri, field, ops, a[:n // 2], a[n // 2:], gen, dev)),
            ("fri_fold", f"{tag}half=1", _fold_case(K, fri, field, ops, a[:1], a[1:2], gen, dev)),
        ]
    ops = LimbOps(F_STARK, dev)
    for log_half in (23, 24):
        values = _canonical(F_STARK, (2 << log_half,), gen, dev)
        lo, hi = values[:1 << log_half], values[1 << log_half:]
        out += [("fri_fold", f"half=2^{log_half}",
                 _fold_case(K, fri, F_STARK, ops, lo, hi, gen, dev)),
                ("fri round", f"half=2^{log_half}", _round_case(fri, ops, lo, hi, gen, dev))]
    # F_P63 at the sizes its 2^20-row prove at lde 16 gives these kernels:
    # 2^24-element LDE columns and a first fold of half 2^23
    ops63 = LimbOps(F_P63, dev)
    a, b = _canonical(F_P63, (1 << 24,), gen, dev), _canonical(F_P63, (1 << 24,), gen, dev)
    out += [
        ("mont_mul", "F_P63 2^24", lambda: K.mont_mul(F_P63, a, b)),
        ("addsub", "F_P63 add 2^24", lambda: K.addsub(F_P63, a, b, "add")),
        ("fri_fold", "F_P63 half=2^23",
         _fold_case(K, fri, F_P63, ops63, a[:1 << 23], a[1 << 23:], gen, dev)),
    ]
    return out


def main(argv) -> int:
    root = os.path.abspath(argv[1] if len(argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    only = argv[2] if len(argv) > 2 else ""
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from hodor_tpu_torch.field import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    if os.path.dirname(os.path.abspath(K.__file__)) != os.path.join(root, "hodor_tpu_torch",
                                                                     "field"):
        raise RuntimeError(f"hodor_tpu_torch came from {K.__file__}, not from {root}")
    K.build_kernels()
    dev = torch.device("cuda", 0)
    for kernel, case, fn in cases(dev):
        if only not in f"{kernel} {case}":
            continue
        device_ms, how, copies = device_time_ms(fn)
        host_us = host_time_us(fn)
        print(json.dumps({"root": root, "kernel": kernel, "case": case, "host_us": host_us,
                          "device_ms": device_ms, "device_by": how, "copies": copies}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
