"""DenseNet (121/169), IR form (counterpart of
`defer_tpu/models/densenet.py`). Only each dense layer's concat output
and the transition layers are valid cuts: the branch inside a dense
layer runs beside the concat skip. Node names follow tf.keras DenseNet
auto-naming (`conv2_block1_1_conv`, `pool2_conv`, ...).
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model

_EPS = 1.001e-5


def _dense_layer(b: GraphBuilder, x: str, growth: int, prefix: str) -> str:
    """BN-ReLU-1x1(4g) -> BN-ReLU-3x3(g), concatenated onto the input."""
    y = b.add("batch_norm", x, name=f"{prefix}_0_bn", eps=_EPS)
    y = b.add("relu", y, name=f"{prefix}_0_relu")
    y = b.add(
        "conv",
        y,
        name=f"{prefix}_1_conv",
        features=4 * growth,
        kernel_size=1,
        padding="VALID",
        use_bias=False,
    )
    y = b.add("batch_norm", y, name=f"{prefix}_1_bn", eps=_EPS)
    y = b.add("relu", y, name=f"{prefix}_1_relu")
    y = b.add(
        "conv",
        y,
        name=f"{prefix}_2_conv",
        features=growth,
        kernel_size=3,
        use_bias=False,
    )
    return b.add("concat", x, y, name=f"{prefix}_concat", axis=-1)


def _transition(b: GraphBuilder, x: str, features: int, prefix: str) -> str:
    x = b.add("batch_norm", x, name=f"{prefix}_bn", eps=_EPS)
    x = b.add("relu", x, name=f"{prefix}_relu")
    x = b.add(
        "conv",
        x,
        name=f"{prefix}_conv",
        features=features,
        kernel_size=1,
        padding="VALID",
        use_bias=False,
    )
    return b.add(
        "avg_pool", x, name=f"{prefix}_pool", window=2, strides=2,
        padding="VALID",
    )


def _build_densenet(
    name: str,
    blocks: tuple[int, ...],
    *,
    growth: int = 32,
    num_classes: int = 1000,
) -> Model:
    b = GraphBuilder(name)
    x = b.input("input")
    x = b.add("zero_pad", x, name="zero_padding2d", padding=((3, 3), (3, 3)))
    x = b.add(
        "conv",
        x,
        name="conv1_conv",
        features=64,
        kernel_size=7,
        strides=2,
        padding="VALID",
        use_bias=False,
    )
    x = b.add("batch_norm", x, name="conv1_bn", eps=_EPS)
    x = b.add("relu", x, name="conv1_relu")
    x = b.add(
        "zero_pad", x, name="zero_padding2d_1", padding=((1, 1), (1, 1))
    )
    x = b.add(
        "max_pool", x, name="pool1", window=3, strides=2, padding="VALID"
    )

    cuts: list[str] = []
    channels = 64
    for gi, num_layers in enumerate(blocks, start=2):
        for li in range(1, num_layers + 1):
            x = _dense_layer(b, x, growth, f"conv{gi}_block{li}")
            channels += growth
            # Each block's concat output dominates everything
            # downstream (later layers see earlier features only
            # through it) — a valid cut; the layer's internal branch
            # is not.
            cuts.append(x)
        if gi - 2 < len(blocks) - 1:
            channels //= 2
            x = _transition(b, x, channels, f"pool{gi}")
            cuts.append(x)

    x = b.add("batch_norm", x, name="bn", eps=_EPS)
    x = b.add("relu", x, name="relu")
    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="predictions", features=num_classes)
    x = b.add("softmax", x, name="predictions_softmax")
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(224, 224, 3),
        cut_candidates=tuple(cuts),
    )


@register_model("densenet121")
def densenet121() -> Model:
    return _build_densenet("densenet121", (6, 12, 24, 16))


@register_model("densenet169")
def densenet169() -> Model:
    return _build_densenet("densenet169", (6, 12, 32, 32))
