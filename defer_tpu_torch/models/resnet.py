"""ResNet v1 (50/101/152), IR form (counterpart of
`defer_tpu/models/resnet.py`), DEFER's headline model.

Residual-sum nodes are named `add_1` ... `add_16` (ResNet50) as in the
TF1-era Keras auto-naming, so reference-style cut lists such as
`["add_4", "add_8", "add_12"]` apply verbatim; every add output
dominates the downstream graph, so each is a valid single-tensor cut.
"""

from __future__ import annotations

import re

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model

_BOTTLENECK_RE = re.compile(r"res(\d+)(.)_(a|b|c|proj)_(conv|bn)$")
_PART_IDX = {"proj": 0, "a": 1, "b": 2, "c": 3}


def _keras_name(node: str) -> str:
    """Native node name -> real tf.keras ResNet layer name, e.g.
    `res2a_a_conv` -> `conv2_block1_1_conv`, `res3b_proj_bn` ->
    `conv3_block2_0_bn`, `fc` -> `predictions` (the names
    `ResNet50(weights='imagenet')` checkpoints use)."""
    if node == "fc":
        return "predictions"
    m = _BOTTLENECK_RE.match(node)
    if m:
        group, letter, part, kind = m.groups()
        block = ord(letter) - ord("a") + 1
        return f"conv{group}_block{block}_{_PART_IDX[part]}_{kind}"
    return node


def _conv_bn_relu(
    b: GraphBuilder,
    x: str,
    features: int,
    kernel: int,
    *,
    strides: int = 1,
    padding: str = "SAME",
    relu: bool = True,
    prefix: str,
) -> str:
    x = b.add(
        "conv",
        x,
        name=f"{prefix}_conv",
        features=features,
        kernel_size=kernel,
        strides=strides,
        padding=padding,
        use_bias=False,
    )
    x = b.add("batch_norm", x, name=f"{prefix}_bn", eps=1.001e-5)
    if relu:
        x = b.add("relu", x, name=f"{prefix}_relu")
    return x


def _bottleneck(
    b: GraphBuilder,
    x: str,
    filters: int,
    *,
    strides: int,
    projection: bool,
    prefix: str,
    add_name: str,
) -> str:
    """Standard v1 bottleneck: 1x1 -> 3x3 -> 1x1(4f) + shortcut."""
    shortcut = x
    if projection:
        shortcut = b.add(
            "conv",
            x,
            name=f"{prefix}_proj_conv",
            features=filters * 4,
            kernel_size=1,
            strides=strides,
            padding="VALID",
            use_bias=False,
        )
        shortcut = b.add(
            "batch_norm", shortcut, name=f"{prefix}_proj_bn", eps=1.001e-5
        )
    y = _conv_bn_relu(
        b, x, filters, 1, strides=strides, padding="VALID", prefix=f"{prefix}_a"
    )
    y = _conv_bn_relu(b, y, filters, 3, prefix=f"{prefix}_b")
    y = _conv_bn_relu(
        b, y, filters * 4, 1, padding="VALID", relu=False, prefix=f"{prefix}_c"
    )
    out = b.add("add", y, shortcut, name=add_name)
    return b.add("relu", out, name=f"{add_name}_relu")


def _build_resnet(
    name: str, blocks_per_group: tuple[int, ...], num_classes: int = 1000
) -> Model:
    b = GraphBuilder(name)
    x = b.input("input")
    x = b.add("zero_pad", x, name="conv1_pad", padding=((3, 3), (3, 3)))
    x = _conv_bn_relu(
        b, x, 64, 7, strides=2, padding="VALID", prefix="conv1"
    )
    x = b.add("zero_pad", x, name="pool1_pad", padding=((1, 1), (1, 1)))
    x = b.add(
        "max_pool", x, name="pool1", window=3, strides=2, padding="VALID"
    )

    adds: list[str] = []
    add_idx = 1
    filters = 64
    for group, num_blocks in enumerate(blocks_per_group, start=2):
        for block in range(num_blocks):
            first = block == 0
            x = _bottleneck(
                b,
                x,
                filters,
                # Group 2 keeps stride 1 (the stem's maxpool already
                # downsampled); later groups downsample in their first block.
                strides=2 if (first and group > 2) else 1,
                projection=first,
                prefix=f"res{group}{chr(ord('a') + block)}",
                add_name=f"add_{add_idx}",
            )
            adds.append(f"add_{add_idx}")
            add_idx += 1
        filters *= 2

    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="fc", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    graph = b.build(x)
    # Cut at the post-add relu so the relu isn't duplicated across stages;
    # `add_N` itself is also valid (it dominates everything downstream).
    return Model(
        name=name,
        graph=graph,
        input_shape=(224, 224, 3),
        cut_candidates=tuple(adds),
        keras_name_map=_keras_name,
    )


@register_model("resnet50")
def resnet50(num_classes: int = 1000) -> Model:
    return _build_resnet("resnet50", (3, 4, 6, 3), num_classes)


@register_model("resnet101")
def resnet101(num_classes: int = 1000) -> Model:
    return _build_resnet("resnet101", (3, 4, 23, 3), num_classes)


@register_model("resnet152")
def resnet152(num_classes: int = 1000) -> Model:
    return _build_resnet("resnet152", (3, 8, 36, 3), num_classes)
