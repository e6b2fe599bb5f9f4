"""Memory-bounded forms engaged a proof (the sum of
profiling.form_counts over the window: trees dropped, leaves hashed in
chunks, LDEs by coset, DEEP tables not kept)."""


def read(ctx):
    return sum(ctx["forms"].values()) / ctx["proofs"]
