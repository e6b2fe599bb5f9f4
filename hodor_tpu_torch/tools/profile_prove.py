"""Device-time breakdown of a warm 2^20-row VDF prove on one GPU.

    python -m hodor_tpu_torch.tools.profile_prove [quadratic|cubic] [B] [F_STARK|F_BLS|F_P63]

(the quadratic VDF unless the cubic is named; with B > 1, a
`Prover.prove_batch` of B lanes, the starts of the lanes after the first
under the first one's instance; over F_STARK unless another field is
named: F_BLS is chip_smoke.py phase 10's field). Builds the kernels,
sets up a prover (lde factor 16, FRI to a constant), runs one cold
prove, then one warm prove without the profiler and one under
`torch.profiler`. Prints:
  - the card's name and power limit (nvidia-smi);
  - the witness chain's host seconds (`into_arp`: the native chain, which
    `witness="auto"` takes at this length) and `ARPInstance.encode_witness`
    alone (the packed array's view and padding, the host->device copy,
    the to-Montgomery mul), synchronized;
  - the warm prove's wall without and with the profiler, and the
    profiled run's stage walls;
  - device busy time: the union of the CUDA kernel, memcpy and memset
    intervals the profiler recorded, and the idle share
    1 - busy / wall against both walls (the profiler adds host time, so
    the share against the profiled wall is an upper bound);
  - device time and launch count per kernel group and the top kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch

LOG_ROWS = 20
STARTS = ((1, 2), (3, 5), (2, 9), (7, 11), (4, 13), (6, 1), (8, 3), (5, 10))

GROUPS = (
    ("ntt_level (mma body)", ("ntt_level_mma_kernel",)),
    ("ntt_level (limb body)", ("ntt_level_kernel",)),
    ("mont_mul", ("mont_mul_kernel", "mont_mul_flat_kernel", "mont_mul_grid_kernel")),
    ("mont_pow", ("mont_pow_kernel",)),
    ("addsub", ("addsub_kernel",)),
    ("blake2s", ("blake2s_kernel",)),
    ("fri_fold", ("fri_fold_kernel",)),
    ("wide_reduce", ("wide_reduce_kernel",)),
    ("dft_reduce", ("dft_reduce_kernel", "dft_reduce_mma_kernel", "s8dot_mma_kernel")),
    ("torch copy/cat/index", ("copy", "Cat", "cat", "index", "gather", "elementwise",
                              "Memcpy", "Memset", "fill")),
)


def _group(name: str) -> str:
    for group, needles in GROUPS:
        if any(s in name for s in needles):
            return group
    return "other torch"


def _union_us(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hodor_tpu_torch.field import F_BLS, F_P63, F_STARK
    from hodor_tpu_torch.field import kernels as K
    from hodor_tpu_torch.models import VDF, CubicVDF
    from hodor_tpu_torch.prover import Prover
    from hodor_tpu_torch.utils.native import build_host_library

    fields = {f.name: f for f in (F_STARK, F_BLS, F_P63)}
    which = argv[1] if len(argv) > 1 else "quadratic"
    lanes = int(argv[2]) if len(argv) > 2 and argv[2].isdigit() else 1
    field = fields.get(argv[3]) if len(argv) > 3 else F_STARK
    if which not in ("quadratic", "cubic") or len(argv) > 4 or not 1 <= lanes <= len(STARTS) \
            or field is None:
        print("usage: python -m hodor_tpu_torch.tools.profile_prove [quadratic|cubic] [B] "
              f"[{'|'.join(fields)}], 1 <= B <= {len(STARTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    K.build_kernels()
    build_host_library()
    steps = (1 << LOG_ROWS) - 1
    starts = ((1, 1),) + STARTS[1:] if which == "cubic" else STARTS
    models = [VDF(field, c0, c1, steps) if which == "quadratic" else
              CubicVDF(field, c0, c1, steps) for c0, c1 in starts[:lanes]]
    t0 = time.perf_counter()
    witness, props = models[0].into_arp()
    print(f"model: {which} VDF over {field.name}, {props.num_registers} registers; witness chain "
          f"({'native' if models[0].native else 'python'}) {time.perf_counter() - t0:.3f} s")
    witnesses = [witness] + [m.into_arp()[0] for m in models[1:]]
    prover = Prover(props.clone(), lde_factor=16, fri_final_degree_plus_one=1, device="cuda")

    def run():
        return prover.prove(witness) if lanes == 1 else prover.prove_batch(witnesses)

    run()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    w = prover.arp.encode_witness(witness)
    torch.cuda.synchronize()
    print(f"encode_witness alone: {time.perf_counter() - t0:.3f} s")
    del w

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_on = time.perf_counter() - t0
    what = "prove" if lanes == 1 else f"prove_batch of {lanes} lanes"
    print(f"warm {what} 2^{LOG_ROWS} rows: {wall_off:.3f} s without the profiler, "
          f"{wall_on:.3f} s under it")
    print(prover.last_timings.report())

    by_name = collections.defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:90]][0] += 1
            by_name[e.name[:90]][1] += e.time_range.elapsed_us()
            intervals.append((e.time_range.start, e.time_range.end))
    total_ms = sum(d for _, d in by_name.values()) / 1e3
    busy_s = _union_us(intervals) / 1e6
    print(f"device events {len(intervals)}, summed device time {total_ms:.1f} ms, "
          f"busy (union) {busy_s * 1e3:.1f} ms; idle share {1 - busy_s / wall_off:.3f} "
          f"of the unprofiled wall, {1 - busy_s / wall_on:.3f} of the profiled wall")
    groups = collections.defaultdict(lambda: [0, 0.0])
    for name, (n, d) in by_name.items():
        groups[_group(name)][0] += n
        groups[_group(name)][1] += d
    for g, (n, d) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"  {g:24s} {n:7d} launches {d / 1e3:10.2f} ms  {100 * d / 1e3 / total_ms:5.1f}%")
    print("top device kernels:")
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {d / 1e3:9.2f} ms {n:6d}x  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
