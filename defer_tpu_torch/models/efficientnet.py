"""EfficientNet-B0/B1, IR form (counterpart of
`defer_tpu/models/efficientnet.py`): stem conv, seven MBConv groups with
squeeze-and-excitation, swish activations, 1280-wide head. Every block
output is a valid single-tensor cut point.
"""

from __future__ import annotations

import math

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model
from defer_tpu_torch.models.mobilenet import _make_divisible


def _conv_bn_swish(
    b: GraphBuilder,
    x: str,
    features: int,
    kernel: int,
    *,
    strides: int = 1,
    swish: bool = True,
    prefix: str,
) -> str:
    x = b.add(
        "conv",
        x,
        name=f"{prefix}_conv",
        features=features,
        kernel_size=kernel,
        strides=strides,
        padding="SAME",
        use_bias=False,
    )
    x = b.add("batch_norm", x, name=f"{prefix}_bn", eps=1e-3)
    if swish:
        x = b.add("swish", x, name=f"{prefix}_activation")
    return x


def _se_block(
    b: GraphBuilder, x: str, in_ch: int, expanded_ch: int, *, prefix: str
) -> str:
    """Squeeze-and-excitation: GAP -> reduce conv -> swish -> expand conv
    -> sigmoid -> channel-wise gate."""
    se_ch = max(1, in_ch // 4)
    s = b.add("global_avg_pool", x, name=f"{prefix}_se_squeeze", keepdims=True)
    s = b.add(
        "conv",
        s,
        name=f"{prefix}_se_reduce",
        features=se_ch,
        kernel_size=1,
        use_bias=True,
    )
    s = b.add("swish", s, name=f"{prefix}_se_reduce_swish")
    s = b.add(
        "conv",
        s,
        name=f"{prefix}_se_expand",
        features=expanded_ch,
        kernel_size=1,
        use_bias=True,
    )
    s = b.add("sigmoid", s, name=f"{prefix}_se_sigmoid")
    return b.add("multiply", x, s, name=f"{prefix}_se_excite")


def _mbconv(
    b: GraphBuilder,
    x: str,
    in_ch: int,
    out_ch: int,
    *,
    kernel: int,
    stride: int,
    expansion: int,
    prefix: str,
) -> tuple[str, int]:
    y = x
    expanded = in_ch * expansion
    if expansion != 1:
        y = _conv_bn_swish(b, y, expanded, 1, prefix=f"{prefix}_expand")
    y = b.add(
        "depthwise_conv",
        y,
        name=f"{prefix}_dwconv",
        kernel_size=kernel,
        strides=stride,
        padding="SAME",
        use_bias=False,
    )
    y = b.add("batch_norm", y, name=f"{prefix}_dwconv_bn", eps=1e-3)
    y = b.add("swish", y, name=f"{prefix}_dwconv_swish")
    y = _se_block(b, y, in_ch, expanded, prefix=prefix)
    y = _conv_bn_swish(
        b, y, out_ch, 1, swish=False, prefix=f"{prefix}_project"
    )
    if stride == 1 and in_ch == out_ch:
        # Inference-mode stochastic depth is the identity, so the block
        # reduces to a plain residual add.
        y = b.add("add", x, y, name=f"{prefix}_add")
    return y, out_ch


# (kernel, first-block stride, expansion, out_channels, repeats) — B0.
_B0_SCHEDULE = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)


def _build_efficientnet(
    name: str,
    width_mult: float,
    depth_mult: float,
    resolution: int,
    num_classes: int,
) -> Model:
    b = GraphBuilder(name)
    x = b.input("input")
    ch = _make_divisible(32 * width_mult)
    x = _conv_bn_swish(b, x, ch, 3, strides=2, prefix="stem")

    cuts: list[str] = []
    for gi, (kernel, stride, expansion, out_base, repeats) in enumerate(
        _B0_SCHEDULE, start=1
    ):
        out_ch = _make_divisible(out_base * width_mult)
        for i in range(int(math.ceil(repeats * depth_mult))):
            x, ch = _mbconv(
                b,
                x,
                ch,
                out_ch,
                kernel=kernel,
                stride=stride if i == 0 else 1,
                expansion=expansion,
                prefix=f"block{gi}{chr(ord('a') + i)}",
            )
            cuts.append(x)

    x = _conv_bn_swish(b, x, _make_divisible(1280 * width_mult), 1, prefix="top")
    cuts.append(x)
    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(resolution, resolution, 3),
        cut_candidates=tuple(cuts),
        keras_name_map=_keras_name,
    )


def _keras_name(node: str) -> str:
    """Native node name -> real tf.keras EfficientNet layer name: the
    depthwise BN is plain `{block}_bn` in Keras, and the softmax head
    is the fused `predictions` Dense."""
    if node == "predictions_dense":
        return "predictions"
    if node.endswith("_dwconv_bn"):
        return node[: -len("_dwconv_bn")] + "_bn"
    return node


@register_model("efficientnet_b0")
def efficientnet_b0(num_classes: int = 1000) -> Model:
    return _build_efficientnet("efficientnet_b0", 1.0, 1.0, 224, num_classes)


@register_model("efficientnet_b1")
def efficientnet_b1(num_classes: int = 1000) -> Model:
    return _build_efficientnet("efficientnet_b1", 1.0, 1.1, 240, num_classes)
