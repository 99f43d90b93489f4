"""The whole step's share of the cards' bf16 peak, in percent: the
configuration's frozen FLOPs an image (`counts/<config>.py`) times the
run's own `images_per_s`, taken over its window with no profiler in the
process, over the published peak (`peaks.py`) times the cards."""

from benchmark import peaks


def read(ctx):
    peak = peaks.bf16_flops(ctx.device["kind"])
    rate = ctx.outcome.metrics.get("images_per_s")
    if peak is None or not rate:
        return None
    flops = ctx.cell.counts.flops_per_image(ctx.cell.config)
    return 100.0 * flops * rate / (peak * ctx.chips)
