"""Seconds a proof in the trace commitment stage (Prover.last_timings,
stage "witness+f_ldes+f_oracles"), over the window."""


def read(ctx):
    return (sum(s for k, s in ctx["stages"].items() if k.endswith("witness+f_ldes+f_oracles"))
            / ctx["proofs"])
