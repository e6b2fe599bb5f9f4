"""Seconds from the process's start to the window's: imports, the
kernels built or loaded, the witnesses and provers, the warm proofs."""


def read(ctx):
    return ctx["setup_s"]
