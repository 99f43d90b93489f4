"""Host ms a microbatch of the stage whose place and launch took the
most: the one stage a thread of its own would have to keep up with."""

from benchmark import host_ms


def read(ctx):
    stages = host_ms.stage_seconds(ctx)
    return host_ms.per_microbatch(ctx, max(stages.values()) if stages else None)
