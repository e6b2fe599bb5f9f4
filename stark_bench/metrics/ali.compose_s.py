"""Seconds a proof under the program's span "ali.compose" (inside ali.g:
the loop over the constraints and their terms, the degree adjustments
and the divisors), the paths of Prover.last_timings ending
"/ali.compose", summed over the window. Host time: the span does not
synchronize. None where the program records no such span."""


def read(ctx):
    found = [s for k, s in ctx["stages"].items() if k.endswith("/ali.compose")]
    return sum(found) / ctx["proofs"] if found else None
