"""Host ms a microbatch spent placing the stages' inputs, summed over
the stages: the HtoD copy's enqueue for stage 0, the card-to-card hop
and any wait it puts on the host for the later ones."""

from benchmark import host_ms


def read(ctx):
    stages = host_ms.stage_seconds(ctx, "place")
    return host_ms.per_microbatch(ctx, sum(stages.values()) if stages else None)
