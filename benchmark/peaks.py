"""Published peaks of the cards the benchmark runs on, frozen here so
that a later change cannot move the yardstick.

Dense bf16 tensor-core FLOP/s (no sparsity) and HBM bytes/s from
NVIDIA's data sheets, at each card's full power limit, keyed by a
substring of `torch.cuda.get_device_name()`; more specific keys first.
A card that is not in the table has no peak, and a metric that needs
one is left out of the result.
"""

from __future__ import annotations

BF16_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),  # SXM, "NVIDIA H100 80GB HBM3"
)
HBM_BYTES = (
    ("h100 pcie", 2.0e12),
    ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),
)


def _lookup(table, kind: str) -> float | None:
    kind = kind.lower()
    for key, value in table:
        if key in kind:
            return value
    return None


def bf16_flops(kind: str) -> float | None:
    return _lookup(BF16_FLOPS, kind)


def hbm_bytes(kind: str) -> float | None:
    return _lookup(HBM_BYTES, kind)
