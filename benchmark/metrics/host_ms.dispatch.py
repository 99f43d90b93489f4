"""Host ms a microbatch that `Pipeline.__call__` spent on its stages,
placing each one's input and enqueueing its kernels, summed over the
stages, over the unprofiled window."""

from benchmark import host_ms


def read(ctx):
    stages = host_ms.stage_seconds(ctx)
    return host_ms.per_microbatch(ctx, sum(stages.values()) if stages else None)
