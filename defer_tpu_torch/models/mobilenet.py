"""MobileNetV2, IR form (counterpart of
`defer_tpu/models/mobilenet.py`): depthwise-separable inverted residual
blocks with Keras-compatible naming (`block_3_add`, ...). Every block
output is a single-tensor cut point.
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _keras_name(node: str) -> str:
    """Native node name -> real tf.keras MobileNetV2 layer name (the
    names `MobileNetV2(weights='imagenet')` checkpoints use): the stem
    pair is `Conv1`/`bn_Conv1`, block convs drop the `_conv` suffix,
    and block BNs use an upper-case `_BN` suffix."""
    if node == "Conv1_conv":
        return "Conv1"
    if node == "Conv1_bn":
        return "bn_Conv1"
    if node == "Conv_1_conv":
        return "Conv_1"
    if node == "predictions_dense":
        return "predictions"
    for stem in ("_expand", "_project"):
        if node.endswith(f"{stem}_conv"):
            return node[: -len("_conv")]
        if node.endswith(f"{stem}_bn"):
            return node[: -len("_bn")] + "_BN"
    if node.endswith("_depthwise_bn"):
        return node[: -len("_bn")] + "_BN"
    return node


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding used by the MobileNet family (nearest multiple
    of 8, never dropping more than 10%)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn(
    b: GraphBuilder,
    x: str,
    features: int,
    kernel: int,
    *,
    strides: int = 1,
    relu6: bool = True,
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
    if relu6:
        x = b.add("relu6", x, name=f"{prefix}_relu")
    return x


def _inverted_residual(
    b: GraphBuilder,
    x: str,
    in_ch: int,
    out_ch: int,
    *,
    stride: int,
    expansion: int,
    block_id: int,
) -> tuple[str, int]:
    """Expand(1x1) -> depthwise(3x3) -> project(1x1, linear) + skip."""
    prefix = f"block_{block_id}" if block_id > 0 else "expanded_conv"
    y = x
    if expansion != 1:
        y = _conv_bn(b, y, in_ch * expansion, 1, prefix=f"{prefix}_expand")
    y = b.add(
        "depthwise_conv",
        y,
        name=f"{prefix}_depthwise",
        kernel_size=3,
        strides=stride,
        padding="SAME",
        use_bias=False,
    )
    y = b.add("batch_norm", y, name=f"{prefix}_depthwise_bn", eps=1e-3)
    y = b.add("relu6", y, name=f"{prefix}_depthwise_relu")
    y = _conv_bn(b, y, out_ch, 1, relu6=False, prefix=f"{prefix}_project")
    if stride == 1 and in_ch == out_ch:
        y = b.add("add", x, y, name=f"{prefix}_add")
    return y, out_ch


# (expansion, out_channels, repeats, first-block stride) per group —
# the standard V2 schedule.
_V2_SCHEDULE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@register_model("mobilenetv2")
def mobilenetv2(num_classes: int = 1000, alpha: float = 1.0) -> Model:
    b = GraphBuilder("mobilenetv2")
    x = b.input("input")
    ch = _make_divisible(32 * alpha)
    x = _conv_bn(b, x, ch, 3, strides=2, prefix="Conv1")

    cuts: list[str] = []
    block_id = 0
    for expansion, out_base, repeats, stride in _V2_SCHEDULE:
        out_ch = _make_divisible(out_base * alpha)
        for i in range(repeats):
            x, ch = _inverted_residual(
                b,
                x,
                ch,
                out_ch,
                stride=stride if i == 0 else 1,
                expansion=expansion,
                block_id=block_id,
            )
            cuts.append(x)
            block_id += 1

    head = _make_divisible(1280 * alpha) if alpha > 1.0 else 1280
    x = _conv_bn(b, x, head, 1, prefix="Conv_1")
    cuts.append(x)
    x = b.add("global_avg_pool", x, name="global_average_pooling2d")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name="mobilenetv2",
        graph=b.build(x),
        input_shape=(224, 224, 3),
        cut_candidates=tuple(cuts),
        keras_name_map=_keras_name,
    )
