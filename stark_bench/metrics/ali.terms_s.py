"""Seconds a proof under the program's span "ali.terms" (inside ali.g: the
masked witness polynomials, the coset-LDEs of the distinct (mask, power)
terms and their powers), the paths of Prover.last_timings ending
"/ali.terms", summed over the window. Host time: the span does not
synchronize. None where the program records no such span."""


def read(ctx):
    found = [s for k, s in ctx["stages"].items() if k.endswith("/ali.terms")]
    return sum(found) / ctx["proofs"] if found else None
