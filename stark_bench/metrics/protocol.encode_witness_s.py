"""Seconds a proof in the program's spans "encode_witness" (the witness
packed into limbs and copied to the device), the spans whose path in
Prover.last_timings ends "/encode_witness", summed over the window. None
where the program records no such span."""


def read(ctx):
    found = [s for k, s in ctx["stages"].items() if k.endswith("/encode_witness")]
    return sum(found) / ctx["proofs"] if found else None
