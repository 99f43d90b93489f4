"""Device ms of the tensor-core kernels, cuDNN's and cuBLAS's, found by
name (ResNet50's convolutions and its one dense layer), per microbatch
dispatched in the traced stretch, summed over the cell's cards."""


def read(ctx):
    return ctx.per_microbatch_ms("conv", "matmul")
