"""Host ms a microbatch from the program's time counters, read over a
run's unprofiled window (the registry's `t0` and `t1` snapshots).

The program times its stream path with float-seconds counters:
`defer_stage_host_seconds_total{phase,stage}` in `Pipeline.__call__`
(`place`: the input's move to the stage's device; `launch`: enqueueing
the stage's kernels) and `defer_stream_wait_seconds_total{on}` in
`run_defer`'s stream thread (`input`: blocked on the input queue, or in
the gather with batching on; `card`: blocked in the `Retirer`'s
barriers). Each reader divides a sum of their growth over the window by
the microbatches dispatched in it. Where the program has no such
counter, or dispatched nothing, a reader returns None.
"""

from __future__ import annotations

import collections

STAGE = "defer_stage_host_seconds_total"
WAIT = "defer_stream_wait_seconds_total"
MICROBATCHES = "defer_pipeline_microbatches_total"


def labels(sample: str) -> dict[str, str]:
    """`name{a="x",b="y"}` -> {"a": "x", "b": "y"} (the program's label
    values hold no comma or quote)."""
    body = sample[sample.index("{") + 1:-1]
    return dict((k, v.strip('"')) for k, v in
                (pair.split("=", 1) for pair in body.split(",")))


def grown(ctx, name: str) -> dict[str, float]:
    """Each series of the counter `name`, by its labels string, and its
    growth over the window."""
    end = ctx.registry.get("t1", {}).get("counters", {})
    return {k: ctx.counter_delta(k, "t0", "t1") for k in end
            if k.startswith(name + "{")}


def per_microbatch(ctx, seconds: float | None) -> float | None:
    n = ctx.counter_delta(MICROBATCHES, "t0", "t1")
    if seconds is None or not n:
        return None
    return 1000.0 * seconds / n


def stage_seconds(ctx, phase: str | None = None) -> dict[str, float]:
    """Seconds a stage over the window, of one phase or of both."""
    out: dict[str, float] = collections.defaultdict(float)
    for k, v in grown(ctx, STAGE).items():
        lab = labels(k)
        if phase is None or lab["phase"] == phase:
            out[lab["stage"]] += v
    return out


def wait_ms(ctx, on: str) -> float | None:
    return per_microbatch(
        ctx, ctx.counter_delta(f'{WAIT}{{on="{on}"}}', "t0", "t1"))
