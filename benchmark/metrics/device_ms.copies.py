"""Device ms of memory copies (host to device, card to card) and of the
memsets that cuDNN and cuBLAS issue for their workspaces, per
microbatch dispatched in the traced stretch, summed over the cell's
cards."""


def read(ctx):
    return ctx.per_microbatch_ms("copies")
