"""The port's attention kernel (`csrc/flash_attention.cu`, found by
name) against its roofline, in percent: the least time the card could
take for the calls it ran, over the device time they took.

A call's least time is the larger of its FLOPs, 4 B H S^2 D, over the
bf16 peak and its bytes, Q, K and V read once and O written once in
bf16, over the HBM peak (`peaks.py`). Each call's shape is the
configuration's (`counts/<config>.py` `attention_calls`) at the mix's
batch."""

from benchmark import peaks

BYTES_PER_ELEMENT = 2  # bfloat16


def read(ctx):
    t = ctx.traced
    kind = ctx.device["kind"]
    flops_peak, bytes_peak = peaks.bf16_flops(kind), peaks.hbm_bytes(kind)
    calls = ctx.cell.counts.attention_calls(ctx.cell.config)
    if t is None or flops_peak is None or not calls:
        return None
    names = [k for k in t.kernel_ms if "flash_fwd" in k]
    ran = sum(t.kernel_calls[k] for k in names)
    measured_ms = sum(t.kernel_ms[k] for k in names)
    if not ran or measured_ms <= 0:
        return None
    b = int(ctx.cell.mix["batch"])
    bound_s = sum(
        max(4.0 * b * h * s * s * d / flops_peak,
            4.0 * b * h * s * d * BYTES_PER_ELEMENT / bytes_peak)
        for h, s, d in calls) / len(calls)
    return 100.0 * bound_s * ran / (measured_ms / 1e3)
