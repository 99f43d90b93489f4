"""Device ms of the elementwise kernels (folded batch norm `addcmul`,
relu, residual add, pad, casts, softmax: every kernel that is not a
copy, a pool, attention or cuDNN's or cuBLAS's), per microbatch
dispatched in the traced stretch, summed over the cell's cards."""


def read(ctx):
    return ctx.per_microbatch_ms("pointwise")
