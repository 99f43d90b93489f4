"""Vision Transformer builders, IR form (counterpart of `_build_vit`,
`vit_b16`, `vit_s16` and `vit_tiny` in `defer_tpu/models/vit.py`).

Pre-LN ViT (Dosovitskiy et al., arXiv 2010.11929):

    patch-embed conv (p x p, stride p) -> tokens -> [class] token ->
    learned pos embedding -> L x (LN, MHA, add, LN, MLP, add) ->
    final LN -> [class] head

Each block's `mha` runs the hand-written `flash_attention` kernel on the
card (S = (image / patch)^2 + 1, 197 at 224 / 16). Cut candidates are
the per-block residual outputs (`block_{i}_out`). The SPMD form
(`SpmdVit`) waits for the port's multi-device work.
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _build_vit(
    name: str,
    *,
    image_size: int,
    patch_size: int,
    num_layers: int,
    dim: int,
    num_heads: int,
    mlp_dim: int,
    num_classes: int = 1000,
) -> Model:
    if image_size % patch_size:
        raise ValueError(
            f"image size {image_size} not divisible by patch {patch_size}"
        )
    grid = image_size // patch_size
    num_tokens = grid * grid + 1  # + [class]

    b = GraphBuilder(name)
    x = b.input()
    x = b.add(
        "conv",
        x,
        name="patch_embed",
        features=dim,
        kernel_size=(patch_size, patch_size),
        strides=(patch_size, patch_size),
        padding="VALID",
    )
    x = b.add("reshape", x, name="tokens", shape=(grid * grid, dim))
    x = b.add("cls_token", x, name="class_token")
    x = b.add(
        "pos_embedding", x, name="position_embedding", max_len=num_tokens
    )
    cuts: list[str] = []
    for i in range(num_layers):
        h = b.add("layer_norm", x, name=f"block_{i}_ln1")
        h = b.add("mha", h, name=f"block_{i}_mha", num_heads=num_heads)
        x = b.add("add", x, h, name=f"block_{i}_attn_out")
        h = b.add("layer_norm", x, name=f"block_{i}_ln2")
        h = b.add("dense", h, name=f"block_{i}_mlp_in", features=mlp_dim)
        h = b.add("gelu", h, name=f"block_{i}_mlp_gelu")
        h = b.add("dense", h, name=f"block_{i}_mlp_out", features=dim)
        x = b.add("add", x, h, name=f"block_{i}_out")
        cuts.append(x)
    x = b.add("layer_norm", x, name="final_ln")
    x = b.add("take_token", x, name="class_out", index=0)
    x = b.add("dense", x, name="head", features=num_classes)
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(image_size, image_size, 3),
        cut_candidates=tuple(cuts[:-1]),  # last block output == tail
    )


@register_model("vit_b16")
def vit_b16(image_size: int = 224) -> Model:
    """ViT-Base/16 (86M params)."""
    return _build_vit(
        "vit_b16",
        image_size=image_size,
        patch_size=16,
        num_layers=12,
        dim=768,
        num_heads=12,
        mlp_dim=3072,
    )


@register_model("vit_s16")
def vit_s16(image_size: int = 224) -> Model:
    """ViT-Small/16 (22M params)."""
    return _build_vit(
        "vit_s16",
        image_size=image_size,
        patch_size=16,
        num_layers=12,
        dim=384,
        num_heads=6,
        mlp_dim=1536,
    )


@register_model("vit_tiny")
def vit_tiny(image_size: int = 32) -> Model:
    """Small config for tests."""
    return _build_vit(
        "vit_tiny",
        image_size=image_size,
        patch_size=8,
        num_layers=4,
        dim=64,
        num_heads=4,
        mlp_dim=128,
        num_classes=10,
    )
