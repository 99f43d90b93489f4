"""Device ms of cuBLAS's kernels, found by name (the dense layers), per
microbatch dispatched in the traced stretch, summed over the cell's
cards."""


def read(ctx):
    return ctx.per_microbatch_ms("matmul")
