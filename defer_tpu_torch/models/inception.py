"""InceptionV3, IR form (counterpart of
`defer_tpu/models/inception.py`): the eleven inception-module concat
outputs are named `mixed0` ... `mixed10` and are the cut candidates;
the branches inside a module are not valid cuts.
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _cb(
    b: GraphBuilder,
    x: str,
    features: int,
    kernel,
    *,
    strides: int = 1,
    padding: str = "SAME",
    prefix: str,
) -> str:
    """conv -> BN -> relu, the Inception-family building block (shared
    with inception_resnet.py)."""
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
    x = b.add("batch_norm", x, name=f"{prefix}_bn", eps=1e-3)
    return b.add("relu", x, name=f"{prefix}_relu")


def _inception_stem(b: GraphBuilder, x: str) -> str:
    """Shared V3 / InceptionResNetV2 stem: 299x299x3 -> 35x35x192."""
    x = _cb(b, x, 32, 3, strides=2, padding="VALID", prefix="stem1")
    x = _cb(b, x, 32, 3, padding="VALID", prefix="stem2")
    x = _cb(b, x, 64, 3, prefix="stem3")
    x = b.add("max_pool", x, name="stem_pool1", window=3, strides=2, padding="VALID")
    x = _cb(b, x, 80, 1, padding="VALID", prefix="stem4")
    x = _cb(b, x, 192, 3, padding="VALID", prefix="stem5")
    return b.add("max_pool", x, name="stem_pool2", window=3, strides=2, padding="VALID")


def _block_a(b: GraphBuilder, x: str, pool_ch: int, *, name: str) -> str:
    """35x35 module: 1x1 / 5x5 / double-3x3 / avgpool branches."""
    b1 = _cb(b, x, 64, 1, prefix=f"{name}_b1x1")
    b5 = _cb(b, x, 48, 1, prefix=f"{name}_b5x5_1")
    b5 = _cb(b, b5, 64, 5, prefix=f"{name}_b5x5_2")
    b3 = _cb(b, x, 64, 1, prefix=f"{name}_b3x3dbl_1")
    b3 = _cb(b, b3, 96, 3, prefix=f"{name}_b3x3dbl_2")
    b3 = _cb(b, b3, 96, 3, prefix=f"{name}_b3x3dbl_3")
    bp = b.add(
        "avg_pool", x, name=f"{name}_pool", window=3, strides=1, padding="SAME"
    )
    bp = _cb(b, bp, pool_ch, 1, prefix=f"{name}_bpool")
    return b.add("concat", b1, b5, b3, bp, name=name)


def _reduction_a(b: GraphBuilder, x: str, *, name: str) -> str:
    """35x35 -> 17x17: strided 3x3 / strided double-3x3 / maxpool."""
    b3 = _cb(b, x, 384, 3, strides=2, padding="VALID", prefix=f"{name}_b3x3")
    bd = _cb(b, x, 64, 1, prefix=f"{name}_b3x3dbl_1")
    bd = _cb(b, bd, 96, 3, prefix=f"{name}_b3x3dbl_2")
    bd = _cb(b, bd, 96, 3, strides=2, padding="VALID", prefix=f"{name}_b3x3dbl_3")
    bp = b.add(
        "max_pool", x, name=f"{name}_pool", window=3, strides=2, padding="VALID"
    )
    return b.add("concat", b3, bd, bp, name=name)


def _block_b(b: GraphBuilder, x: str, mid: int, *, name: str) -> str:
    """17x17 module with factorized 7x1/1x7 branches."""
    b1 = _cb(b, x, 192, 1, prefix=f"{name}_b1x1")
    b7 = _cb(b, x, mid, 1, prefix=f"{name}_b7x7_1")
    b7 = _cb(b, b7, mid, (1, 7), prefix=f"{name}_b7x7_2")
    b7 = _cb(b, b7, 192, (7, 1), prefix=f"{name}_b7x7_3")
    bd = _cb(b, x, mid, 1, prefix=f"{name}_b7x7dbl_1")
    bd = _cb(b, bd, mid, (7, 1), prefix=f"{name}_b7x7dbl_2")
    bd = _cb(b, bd, mid, (1, 7), prefix=f"{name}_b7x7dbl_3")
    bd = _cb(b, bd, mid, (7, 1), prefix=f"{name}_b7x7dbl_4")
    bd = _cb(b, bd, 192, (1, 7), prefix=f"{name}_b7x7dbl_5")
    bp = b.add(
        "avg_pool", x, name=f"{name}_pool", window=3, strides=1, padding="SAME"
    )
    bp = _cb(b, bp, 192, 1, prefix=f"{name}_bpool")
    return b.add("concat", b1, b7, bd, bp, name=name)


def _reduction_b(b: GraphBuilder, x: str, *, name: str) -> str:
    """17x17 -> 8x8."""
    b3 = _cb(b, x, 192, 1, prefix=f"{name}_b3x3_1")
    b3 = _cb(b, b3, 320, 3, strides=2, padding="VALID", prefix=f"{name}_b3x3_2")
    b7 = _cb(b, x, 192, 1, prefix=f"{name}_b7x7x3_1")
    b7 = _cb(b, b7, 192, (1, 7), prefix=f"{name}_b7x7x3_2")
    b7 = _cb(b, b7, 192, (7, 1), prefix=f"{name}_b7x7x3_3")
    b7 = _cb(b, b7, 192, 3, strides=2, padding="VALID", prefix=f"{name}_b7x7x3_4")
    bp = b.add(
        "max_pool", x, name=f"{name}_pool", window=3, strides=2, padding="VALID"
    )
    return b.add("concat", b3, b7, bp, name=name)


def _block_c(b: GraphBuilder, x: str, *, name: str) -> str:
    """8x8 module with split 1x3/3x1 fan-out branches."""
    b1 = _cb(b, x, 320, 1, prefix=f"{name}_b1x1")
    b3 = _cb(b, x, 384, 1, prefix=f"{name}_b3x3_1")
    b3a = _cb(b, b3, 384, (1, 3), prefix=f"{name}_b3x3_2a")
    b3b = _cb(b, b3, 384, (3, 1), prefix=f"{name}_b3x3_2b")
    b3 = b.add("concat", b3a, b3b, name=f"{name}_b3x3")
    bd = _cb(b, x, 448, 1, prefix=f"{name}_b3x3dbl_1")
    bd = _cb(b, bd, 384, 3, prefix=f"{name}_b3x3dbl_2")
    bda = _cb(b, bd, 384, (1, 3), prefix=f"{name}_b3x3dbl_3a")
    bdb = _cb(b, bd, 384, (3, 1), prefix=f"{name}_b3x3dbl_3b")
    bd = b.add("concat", bda, bdb, name=f"{name}_b3x3dbl")
    bp = b.add(
        "avg_pool", x, name=f"{name}_pool", window=3, strides=1, padding="SAME"
    )
    bp = _cb(b, bp, 192, 1, prefix=f"{name}_bpool")
    return b.add("concat", b1, b3, bd, bp, name=name)


@register_model("inceptionv3")
def inceptionv3(num_classes: int = 1000) -> Model:
    b = GraphBuilder("inceptionv3")
    x = b.input("input")
    x = _inception_stem(b, x)

    x = _block_a(b, x, 32, name="mixed0")
    x = _block_a(b, x, 64, name="mixed1")
    x = _block_a(b, x, 64, name="mixed2")
    x = _reduction_a(b, x, name="mixed3")
    x = _block_b(b, x, 128, name="mixed4")
    x = _block_b(b, x, 160, name="mixed5")
    x = _block_b(b, x, 160, name="mixed6")
    x = _block_b(b, x, 192, name="mixed7")
    x = _reduction_b(b, x, name="mixed8")
    x = _block_c(b, x, name="mixed9")
    x = _block_c(b, x, name="mixed10")

    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name="inceptionv3",
        graph=b.build(x),
        input_shape=(299, 299, 3),
        cut_candidates=tuple(f"mixed{i}" for i in range(11)),
    )
