"""Seconds a proof in the program's spans "query.assemble" (the query
stage's openings turned into proof objects on the host), the paths of
Prover.last_timings ending "/query.assemble", summed over the window.
None where the program records no such span."""


def read(ctx):
    found = [s for k, s in ctx["stages"].items() if k.endswith("/query.assemble")]
    return sum(found) / ctx["proofs"] if found else None
