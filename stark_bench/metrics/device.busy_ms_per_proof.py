"""Milliseconds a proof in which the device ran something (the union of
the device intervals of the traced calls, over their proofs)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["proofs"]
