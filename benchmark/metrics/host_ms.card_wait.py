"""Host ms a microbatch that `run_defer`'s stream thread spent blocked
in the `Retirer`'s barriers, waiting for the cards. It falls when a
card gets faster and rises when the host does in a card-bound cell."""

from benchmark import host_ms


def read(ctx):
    return host_ms.wait_ms(ctx, "card")
