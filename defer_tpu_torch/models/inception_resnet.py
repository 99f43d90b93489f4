"""InceptionResNetV2, IR form (counterpart of
`defer_tpu/models/inception_resnet.py`): residual multi-branch blocks
(inception-style concat, a scaled 1x1 "up" conv, a residual add); every
block output is a valid cut, a cut through a branch is rejected.
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model
from defer_tpu_torch.models.inception import _cb, _inception_stem


def _residual_block(
    b: GraphBuilder,
    x: str,
    branches: list[str],
    out_ch: int,
    scale: float,
    *,
    name: str,
    relu: bool = True,
) -> str:
    """concat(branches) -> 1x1 linear conv -> *scale -> + x [-> relu].

    The 'up' conv has a bias and no BN, matching the residual family's
    block design.
    """
    mixed = (
        b.add("concat", *branches, name=f"{name}_mixed")
        if len(branches) > 1
        else branches[0]
    )
    up = b.add(
        "conv",
        mixed,
        name=f"{name}_conv",
        features=out_ch,
        kernel_size=1,
        use_bias=True,
    )
    up = b.add("scale", up, name=f"{name}_scale", value=scale)
    out = b.add("add", x, up, name=f"{name}_add")
    if relu:
        out = b.add("relu", out, name=name)
    return out


def _block35(b: GraphBuilder, x: str, scale: float, *, name: str) -> str:
    b0 = _cb(b, x, 32, 1, prefix=f"{name}_b0")
    b1 = _cb(b, x, 32, 1, prefix=f"{name}_b1_0")
    b1 = _cb(b, b1, 32, 3, prefix=f"{name}_b1_1")
    b2 = _cb(b, x, 32, 1, prefix=f"{name}_b2_0")
    b2 = _cb(b, b2, 48, 3, prefix=f"{name}_b2_1")
    b2 = _cb(b, b2, 64, 3, prefix=f"{name}_b2_2")
    return _residual_block(b, x, [b0, b1, b2], 320, scale, name=name)


def _block17(b: GraphBuilder, x: str, scale: float, *, name: str) -> str:
    b0 = _cb(b, x, 192, 1, prefix=f"{name}_b0")
    b1 = _cb(b, x, 128, 1, prefix=f"{name}_b1_0")
    b1 = _cb(b, b1, 160, (1, 7), prefix=f"{name}_b1_1")
    b1 = _cb(b, b1, 192, (7, 1), prefix=f"{name}_b1_2")
    return _residual_block(b, x, [b0, b1], 1088, scale, name=name)


def _block8(
    b: GraphBuilder, x: str, scale: float, *, name: str, relu: bool = True
) -> str:
    b0 = _cb(b, x, 192, 1, prefix=f"{name}_b0")
    b1 = _cb(b, x, 192, 1, prefix=f"{name}_b1_0")
    b1 = _cb(b, b1, 224, (1, 3), prefix=f"{name}_b1_1")
    b1 = _cb(b, b1, 256, (3, 1), prefix=f"{name}_b1_2")
    return _residual_block(b, x, [b0, b1], 2080, scale, name=name, relu=relu)


@register_model("inception_resnet_v2")
def inception_resnet_v2(num_classes: int = 1000) -> Model:
    b = GraphBuilder("inception_resnet_v2")
    x = b.input("input")
    x = _inception_stem(b, x)

    # mixed_5b (Inception-A): -> 35x35x320.
    a0 = _cb(b, x, 96, 1, prefix="mixed_5b_b0")
    a1 = _cb(b, x, 48, 1, prefix="mixed_5b_b1_0")
    a1 = _cb(b, a1, 64, 5, prefix="mixed_5b_b1_1")
    a2 = _cb(b, x, 64, 1, prefix="mixed_5b_b2_0")
    a2 = _cb(b, a2, 96, 3, prefix="mixed_5b_b2_1")
    a2 = _cb(b, a2, 96, 3, prefix="mixed_5b_b2_2")
    ap = b.add(
        "avg_pool", x, name="mixed_5b_pool", window=3, strides=1, padding="SAME"
    )
    ap = _cb(b, ap, 64, 1, prefix="mixed_5b_bpool")
    x = b.add("concat", a0, a1, a2, ap, name="mixed_5b")

    cuts: list[str] = []
    for i in range(1, 11):
        x = _block35(b, x, 0.17, name=f"block35_{i}")
        cuts.append(x)

    # mixed_6a (Reduction-A): -> 17x17x1088.
    r0 = _cb(b, x, 384, 3, strides=2, padding="VALID", prefix="mixed_6a_b0")
    r1 = _cb(b, x, 256, 1, prefix="mixed_6a_b1_0")
    r1 = _cb(b, r1, 256, 3, prefix="mixed_6a_b1_1")
    r1 = _cb(b, r1, 384, 3, strides=2, padding="VALID", prefix="mixed_6a_b1_2")
    rp = b.add(
        "max_pool", x, name="mixed_6a_pool", window=3, strides=2, padding="VALID"
    )
    x = b.add("concat", r0, r1, rp, name="mixed_6a")
    cuts.append(x)

    for i in range(1, 21):
        x = _block17(b, x, 0.1, name=f"block17_{i}")
        cuts.append(x)

    # mixed_7a (Reduction-B): -> 8x8x2080.
    s0 = _cb(b, x, 256, 1, prefix="mixed_7a_b0_0")
    s0 = _cb(b, s0, 384, 3, strides=2, padding="VALID", prefix="mixed_7a_b0_1")
    s1 = _cb(b, x, 256, 1, prefix="mixed_7a_b1_0")
    s1 = _cb(b, s1, 288, 3, strides=2, padding="VALID", prefix="mixed_7a_b1_1")
    s2 = _cb(b, x, 256, 1, prefix="mixed_7a_b2_0")
    s2 = _cb(b, s2, 288, 3, prefix="mixed_7a_b2_1")
    s2 = _cb(b, s2, 320, 3, strides=2, padding="VALID", prefix="mixed_7a_b2_2")
    sp = b.add(
        "max_pool", x, name="mixed_7a_pool", window=3, strides=2, padding="VALID"
    )
    x = b.add("concat", s0, s1, s2, sp, name="mixed_7a")
    cuts.append(x)

    for i in range(1, 10):
        x = _block8(b, x, 0.2, name=f"block8_{i}")
        cuts.append(x)
    x = _block8(b, x, 1.0, name="block8_10", relu=False)
    cuts.append(x)

    x = _cb(b, x, 1536, 1, prefix="conv_7b")
    cuts.append(x)
    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name="inception_resnet_v2",
        graph=b.build(x),
        input_shape=(299, 299, 3),
        cut_candidates=tuple(cuts),
    )
