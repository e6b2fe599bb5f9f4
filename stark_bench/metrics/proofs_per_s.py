"""Proofs completed in the window over the window's whole time (a batch
call counts its lanes); the window ends as its last call returns."""


def read(ctx):
    return ctx["proofs"] / ctx["window_s"]
