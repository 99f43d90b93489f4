"""VGG16/VGG19, IR form (counterpart of `defer_tpu/models/vgg.py`):
deep sequential CNNs; every conv and block-boundary pool output is a
valid cut."""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _build_vgg(
    name: str, convs_per_block: tuple[int, ...], num_classes: int = 1000
) -> Model:
    widths = (64, 128, 256, 512, 512)
    b = GraphBuilder(name)
    x = b.input("input")
    cuts: list[str] = []
    for blk, (n_convs, width) in enumerate(
        zip(convs_per_block, widths), start=1
    ):
        for i in range(1, n_convs + 1):
            x = b.add(
                "conv",
                x,
                name=f"block{blk}_conv{i}",
                features=width,
                kernel_size=3,
                use_bias=True,
            )
            x = b.add("relu", x, name=f"block{blk}_relu{i}")
            cuts.append(x)
        x = b.add(
            "max_pool", x, name=f"block{blk}_pool", window=2, strides=2
        )
        cuts.append(x)
    x = b.add("flatten", x, name="flatten")
    x = b.add("dense", x, name="fc1", features=4096)
    x = b.add("relu", x, name="fc1_relu")
    x = b.add("dense", x, name="fc2", features=4096)
    x = b.add("relu", x, name="fc2_relu")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(224, 224, 3),
        cut_candidates=tuple(cuts),
        # Node names already match real tf.keras VGG checkpoints
        # (block{b}_conv{i}, fc1, fc2) except the split softmax head.
        keras_name_map=lambda n: (
            "predictions" if n == "predictions_dense" else n
        ),
    )


@register_model("vgg16")
def vgg16(num_classes: int = 1000) -> Model:
    return _build_vgg("vgg16", (2, 2, 3, 3, 3), num_classes)


@register_model("vgg19")
def vgg19(num_classes: int = 1000) -> Model:
    return _build_vgg("vgg19", (2, 2, 4, 4, 4), num_classes)
