"""Percent of the traced stretch in which no kernel or copy ran on a
card (1 - the union of its kernel and copy intervals over the
stretch), averaged over the cell's cards."""


def read(ctx):
    return ctx.idle_share_pct()
