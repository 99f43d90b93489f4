"""Frozen counts of ResNet50 (`configs/resnet50.json`): the FLOPs of one
image's forward pass, two per multiply-add of every convolution and of
the classifier; batch norms, activations, pools and sums are left out.
Computed from the configuration's sizes, not from the program."""

from __future__ import annotations


def flops_per_image(cfg: dict) -> float:
    size = int(cfg["image_size"])
    k, stem = int(cfg["stem_kernel"]), int(cfg["stem_features"])
    hw = size // 2  # the stem conv, stride 2
    total = 2.0 * hw * hw * stem * k * k * int(cfg["channels"])
    hw //= 2  # max pool, stride 2
    cin, exp = stem, int(cfg["expansion"])
    for stage, (n, f) in enumerate(zip(cfg["blocks_per_stage"],
                                       cfg["stage_widths"])):
        for b in range(int(n)):
            if b == 0 and stage > 0:
                hw //= 2
            pos = hw * hw
            if b == 0:
                total += 2.0 * pos * cin * f * exp  # projection, 1x1
            total += 2.0 * pos * (cin * f + 9 * f * f + f * f * exp)
            cin = f * exp
    return total + 2.0 * cin * int(cfg["num_classes"])


def attention_calls(cfg: dict) -> list[tuple[int, int, int]]:
    """(heads, sequence, head size) of each attention call an image
    makes: none."""
    return []
