"""Seconds a proof in the program's Fiat-Shamir transcript spans (the
paths of Prover.last_timings whose last part is "transcript": commits and
challenge draws between the stages and inside ALI and DEEP), summed over
the window. None where the program records no such span."""


def read(ctx):
    found = [s for k, s in ctx["stages"].items() if k.rsplit("/", 1)[-1] == "transcript"]
    return sum(found) / ctx["proofs"] if found else None
