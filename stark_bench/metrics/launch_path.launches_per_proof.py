"""Launches of the program's own kernels a proof (the sum of
field.kernels.launch_counts over the window)."""


def read(ctx):
    return sum(ctx["launches"].values()) / ctx["proofs"]
