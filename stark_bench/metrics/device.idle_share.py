"""100 x (1 - device busy a proof / wall time a proof in the window): busy
is the union of the device intervals torch.profiler recorded over the
traced calls, a proof; the wall time a proof is the untraced window's,
so the profiler's own host time is not read as idle."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / tr["proofs"]) / (ctx["window_s"] / ctx["proofs"]))
