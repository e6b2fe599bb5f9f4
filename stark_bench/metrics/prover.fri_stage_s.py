"""Seconds a proof in the FRI stage (Prover.last_timings, stage
"fri_h1+h2"; a batch's "batch:fri_h1+h2" shared by its lanes), over the
window."""


def read(ctx):
    return sum(s for k, s in ctx["stages"].items() if k.endswith("fri_h1+h2")) / ctx["proofs"]
