"""torch.cuda.max_memory_allocated over the window, in GiB (the peak
statistics reset after the warm proofs)."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
