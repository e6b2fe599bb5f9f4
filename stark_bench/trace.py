"""Reading a torch.profiler trace: device busy time as the union of the
device intervals, device time by kernel group, and the breakdown the
result line carries. `GROUPS`, `group` and `union_us` are copies of
hodor_tpu_torch/tools/profile_prove.py's `GROUPS`, `_group` and
`_union_us`, held here so that the yardstick does not move with the
program."""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

GROUPS = (
    ("ntt_level (mma body)", ("ntt_level_mma_kernel",)),
    ("ntt_level (butterfly body)", ("ntt_level_butterfly_kernel",)),
    ("ntt_level (limb body)", ("ntt_level_kernel",)),
    ("mont_mul", ("mont_mul_kernel", "mont_mul_flat_kernel", "mont_mul_grid_kernel")),
    ("mont_pow", ("mont_pow_kernel",)),
    ("addsub", ("addsub_flat_kernel", "addsub_grid_kernel", "addsub_general_kernel")),
    ("blake2s", ("blake2s_kernel",)),
    ("fri_fold", ("fri_fold_kernel",)),
    ("wide_reduce", ("wide_reduce_kernel",)),
    ("dft_reduce", ("dft_reduce_kernel", "dft_reduce_mma_kernel", "s8dot_mma_kernel")),
    ("torch copy/cat/index", ("copy", "Cat", "cat", "index", "gather", "elementwise",
                              "Memcpy", "Memset", "fill")),
)
# the groups that run a number-theoretic transform level, whatever form
NTT_GROUPS = ("ntt_level (mma body)", "ntt_level (butterfly body)", "ntt_level (limb body)",
              "wide_reduce", "dft_reduce")
TOP = 10


def group(name: str) -> str:
    for g, needles in GROUPS:
        if any(s in name for s in needles):
            return g
    return "other torch"


def union_us(intervals) -> float:
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


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


# the harness's own range around each traced call: the profiler shows
# it on the device's timeline too, where it is no device work
CALL_RANGE = "stark_bench.call"


def read(events) -> Dict:
    """From a profiler's events: busy seconds, seconds by group, the
    device operations that took most time, and the idle gaps between
    device work summed by the innermost host operation open when each
    gap began."""
    from torch.autograd import DeviceType

    device, host = [], []
    by_name: Dict[str, float] = collections.defaultdict(float)
    by_group: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name == CALL_RANGE:
                continue
            device.append((s, t))
            by_name[e.name] += (t - s) / 1e6
            by_group[group(e.name)] += (t - s) / 1e6
        else:
            host.append((s, t, e.name))
    gaps: Dict[str, float] = collections.defaultdict(float)
    merged = _merged(device)
    host.sort()
    active: List[Tuple[float, float, str]] = []  # host operations begun, by start
    i = 0
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        while i < len(host) and host[i][0] <= e0:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= e0]
        gaps[active[-1][2] if active else "(no host operation)"] += (s1 - e0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": union_us(device) / 1e6, "groups": dict(by_group),
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
