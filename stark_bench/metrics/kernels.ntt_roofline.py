"""100 x the H100's least time for the transforms a proof needs
(roofline.ntt_work_s, from the configuration's sizes) over the device
time of the transform kernels a proof (the groups trace.NTT_GROUPS)."""

from stark_bench import roofline
from stark_bench.trace import NTT_GROUPS


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    device_s = sum(tr["groups"].get(g, 0.0) for g in NTT_GROUPS) / tr["proofs"]
    if device_s <= 0:
        return None
    return 100.0 * roofline.ntt_work_s(*ctx["shape"]) / device_s
