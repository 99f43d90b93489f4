"""Xception, IR form (counterpart of `defer_tpu/models/xception.py`):
entry flow, 8 middle-flow residual blocks of 728-channel separable
convs, exit flow. Every block's add output is a valid cut. Keras layer
names match `keras.applications.Xception` (`_keras_name` reproduces the
auto-named residual-shortcut conv/BN pairs).
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model

# Residual-shortcut pairs in Keras build order: our node prefix ->
# index of the auto-named Conv2D/BatchNormalization instance.
_RES_ORDER = ("block2", "block3", "block4", "block13")


def _keras_name(node: str) -> str:
    for i, blk in enumerate(_RES_ORDER):
        suffix = f"_{i}" if i else ""
        if node == f"{blk}_res_conv":
            return f"conv2d{suffix}"
        if node == f"{blk}_res_bn":
            return f"batch_normalization{suffix}"
    if node == "predictions_dense":
        return "predictions"
    return node


def _sepconv_bn(
    b: GraphBuilder,
    x: str,
    features: int,
    name: str,
    *,
    act_before: bool = True,
) -> str:
    """relu -> SeparableConv2D -> BN, Keras's pre-activation ordering
    (the activation is named for the conv it precedes)."""
    if act_before:
        x = b.add("relu", x, name=f"{name}_act")
    x = b.add(
        "separable_conv",
        x,
        name=name,
        features=features,
        kernel_size=3,
        padding="SAME",
        use_bias=False,
    )
    return b.add("batch_norm", x, name=f"{name}_bn", eps=1e-3)


def _down_block(
    b: GraphBuilder,
    x: str,
    features: int,
    blk: str,
    *,
    first_act: bool,
    last_features: int | None = None,
) -> str:
    """Two sepconvs + strided pool, added to a strided 1x1 shortcut."""
    res = b.add(
        "conv",
        x,
        name=f"{blk}_res_conv",
        features=last_features or features,
        kernel_size=1,
        strides=2,
        padding="SAME",
        use_bias=False,
    )
    res = b.add("batch_norm", res, name=f"{blk}_res_bn", eps=1e-3)
    x = _sepconv_bn(b, x, features, f"{blk}_sepconv1", act_before=first_act)
    # Keras names this activation for the conv it feeds (sepconv2).
    x = b.add("relu", x, name=f"{blk}_sepconv2_act")
    x = _sepconv_bn(
        b, x, last_features or features, f"{blk}_sepconv2", act_before=False
    )
    x = b.add(
        "max_pool",
        x,
        name=f"{blk}_pool",
        pool_size=3,
        strides=2,
        padding="SAME",
    )
    return b.add("add", x, res, name=f"{blk}_add")


@register_model("xception")
def xception(num_classes: int = 1000) -> Model:
    b = GraphBuilder("xception")
    x = b.input("input")

    # Entry flow: two VALID-padded stem convs...
    for i, (feat, stride) in enumerate(((32, 2), (64, 1)), start=1):
        x = b.add(
            "conv",
            x,
            name=f"block1_conv{i}",
            features=feat,
            kernel_size=3,
            strides=stride,
            padding="VALID",
            use_bias=False,
        )
        x = b.add("batch_norm", x, name=f"block1_conv{i}_bn", eps=1e-3)
        x = b.add("relu", x, name=f"block1_conv{i}_act")

    cuts: list[str] = []
    # ...then three downsampling sepconv blocks. block2's first sepconv
    # follows a ReLU already applied above, so it has no pre-act.
    x = _down_block(b, x, 128, "block2", first_act=False)
    cuts.append(x)
    x = _down_block(b, x, 256, "block3", first_act=True)
    cuts.append(x)
    x = _down_block(b, x, 728, "block4", first_act=True)
    cuts.append(x)

    # Middle flow: 8 identity-residual blocks of three 728 sepconvs.
    for bi in range(5, 13):
        res = x
        for si in range(1, 4):
            x = _sepconv_bn(b, x, 728, f"block{bi}_sepconv{si}")
        x = b.add("add", x, res, name=f"block{bi}_add")
        cuts.append(x)

    # Exit flow.
    x = _down_block(
        b, x, 728, "block13", first_act=True, last_features=1024
    )
    cuts.append(x)
    x = _sepconv_bn(b, x, 1536, "block14_sepconv1", act_before=False)
    x = b.add("relu", x, name="block14_sepconv1_act")
    x = _sepconv_bn(b, x, 2048, "block14_sepconv2", act_before=False)
    x = b.add("relu", x, name="block14_sepconv2_act")
    cuts.append(x)

    x = b.add("global_avg_pool", x, name="avg_pool")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name="xception",
        graph=b.build(x),
        input_shape=(299, 299, 3),
        cut_candidates=tuple(cuts),
        keras_name_map=_keras_name,
    )
