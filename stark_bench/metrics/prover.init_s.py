"""Seconds a proof under the program's span "prover.init" (each call's
new Prover built: its ARP routing and ALI tables), from Prover.last_timings
summed over the window. None where the program records no such span."""


def read(ctx):
    if "prover.init" not in ctx["stages"]:
        return None
    return ctx["stages"]["prover.init"] / ctx["proofs"]
