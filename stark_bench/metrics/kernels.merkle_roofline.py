"""100 x the H100's least time for the Blake2s blocks of every tree a
proof commits (roofline.merkle_work_s, from the configuration's sizes)
over the device time of the blake2s kernel a proof."""

from stark_bench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    device_s = tr["groups"].get("blake2s", 0.0) / tr["proofs"]
    if device_s <= 0:
        return None
    return 100.0 * roofline.merkle_work_s(*ctx["shape"], ctx["config"]["fri_final_degree_plus_one"]) \
        / device_s
