"""Frozen counts of ViT-B/16 (`configs/vit_b16.json`): the FLOPs of one
image's forward pass, two per multiply-add of the patch projection, the
attention projections, the two attention products, the MLP and the
head (on the class token); norms, softmax and GELU are left out. And the
shape of each attention call, for the attention kernel's roofline.
Computed from the configuration's sizes, not from the program."""

from __future__ import annotations


def _sizes(cfg: dict):
    p = int(cfg["patch_size"])
    patches = (int(cfg["image_size"]) // p) ** 2
    return (p, patches, patches + 1, int(cfg["hidden_size"]),
            int(cfg["intermediate_size"]))


def flops_per_image(cfg: dict) -> float:
    p, patches, s, d, f = _sizes(cfg)
    total = 2.0 * patches * p * p * int(cfg["num_channels"]) * d
    per_layer = (2.0 * s * 4 * d * d  # q, k, v, o
                 + 2.0 * 2 * s * s * d  # q k^T and p v
                 + 2.0 * 2 * s * d * f)  # the MLP's two products
    total += int(cfg["num_hidden_layers"]) * per_layer
    return total + 2.0 * d * int(cfg["num_labels"])


def attention_calls(cfg: dict) -> list[tuple[int, int, int]]:
    """(heads, sequence, head size) of each attention call an image
    makes: one a layer."""
    _, _, s, d, _ = _sizes(cfg)
    h = int(cfg["num_attention_heads"])
    return [(h, s, d // h)] * int(cfg["num_hidden_layers"])
