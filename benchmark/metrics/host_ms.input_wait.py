"""Host ms a microbatch that `run_defer`'s stream thread spent blocked
waiting for input (queue gets, timeouts included)."""

from benchmark import host_ms


def read(ctx):
    return host_ms.wait_ms(ctx, "input")
