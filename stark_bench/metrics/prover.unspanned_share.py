"""100 x (1 - seconds under the program's top-level spans / seconds of the
calls), over the window: how much of each call no span of the program
covers. The top-level spans are the paths of Prover.last_timings without
a "/"; a call's seconds are its latency (a batch call's latency is
listed once a lane). None where the program records no span."""


def read(ctx):
    spanned = sum(s for k, s in ctx["stages"].items() if "/" not in k)
    calls_s = sum(ctx["latencies"]) / ctx["traffic"]["lanes"]
    if spanned <= 0 or calls_s <= 0:
        return None
    return 100.0 * (1.0 - spanned / calls_s)
