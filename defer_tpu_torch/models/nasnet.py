"""NASNet (Mobile / Large), IR form (counterpart of
`defer_tpu/models/nasnet.py`).

Cell i consumes both cell i-1's and cell i-2's outputs, so a cell
boundary is no single-tensor articulation point: `cut_candidates` holds
the multi-tensor bundles (cell_i, cell_{i-1}) that jointly separate the
chain (graph/partition.py), plus the stem conv output and the final
cell's concat, which stay single-tensor.
"""

from __future__ import annotations

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _sep_conv_block(
    b: GraphBuilder,
    x: str,
    filters: int,
    kernel: int,
    *,
    strides: int = 1,
    prefix: str,
) -> str:
    """relu -> sepconv(s) -> BN -> relu -> sepconv(1) -> BN."""
    x = b.add("relu", x, name=f"{prefix}_relu1")
    for i, s in enumerate((strides, 1), start=1):
        x = b.add(
            "depthwise_conv",
            x,
            name=f"{prefix}_sep{i}_dw",
            kernel_size=kernel,
            strides=s,
            padding="SAME",
            use_bias=False,
        )
        x = b.add(
            "conv",
            x,
            name=f"{prefix}_sep{i}_pw",
            features=filters,
            kernel_size=1,
            use_bias=False,
        )
        x = b.add("batch_norm", x, name=f"{prefix}_sep{i}_bn", eps=1e-3)
        if i == 1:
            x = b.add("relu", x, name=f"{prefix}_relu2")
    return x


def _fit_reduce(b: GraphBuilder, p: str, filters: int, *, prefix: str) -> str:
    """Halve p's spatial dims with the two shifted avg-pool paths
    (factorized reduction), then 1x1-project each half and concat."""
    p = b.add("relu", p, name=f"{prefix}_relu")
    p1 = b.add(
        "avg_pool", p, name=f"{prefix}_pool1", window=1, strides=2,
        padding="VALID",
    )
    p1 = b.add(
        "conv", p1, name=f"{prefix}_conv1", features=filters // 2,
        kernel_size=1, use_bias=False,
    )
    # Second path samples the grid offset by one pixel: pad bottom/right,
    # crop top/left, then the same stride-2 1x1 pool.
    p2 = b.add("zero_pad", p, name=f"{prefix}_pad", padding=((0, 1), (0, 1)))
    p2 = b.add("crop", p2, name=f"{prefix}_crop", cropping=((1, 0), (1, 0)))
    p2 = b.add(
        "avg_pool", p2, name=f"{prefix}_pool2", window=1, strides=2,
        padding="VALID",
    )
    # Both halves get filters//2 (mirroring the canonical factorized
    # reduction); for odd filters the adjusted tensor has filters-1
    # channels, which is fine — reduction cells only consume it through
    # re-projecting separable convs.
    p2 = b.add(
        "conv", p2, name=f"{prefix}_conv2", features=filters // 2,
        kernel_size=1, use_bias=False,
    )
    p = b.add("concat", p1, p2, name=f"{prefix}_concat")
    return b.add("batch_norm", p, name=f"{prefix}_bn", eps=1e-3)


def _adjust(
    b: GraphBuilder,
    p: str | None,
    ip: str,
    filters: int,
    *,
    p_stride_mismatch: bool,
    p_channels: int,
    prefix: str,
) -> str:
    """Shape p (cell i-2 output) to match ip's spatial dims / channels."""
    if p is None:
        return ip
    if p_stride_mismatch:
        return _fit_reduce(b, p, filters, prefix=f"{prefix}_adjust")
    if p_channels != filters:
        p = b.add("relu", p, name=f"{prefix}_adjust_relu")
        p = b.add(
            "conv", p, name=f"{prefix}_adjust_conv", features=filters,
            kernel_size=1, use_bias=False,
        )
        return b.add("batch_norm", p, name=f"{prefix}_adjust_bn", eps=1e-3)
    return p


def _squeeze(b: GraphBuilder, x: str, filters: int, *, prefix: str) -> str:
    """relu -> 1x1 conv -> BN entry projection (h path)."""
    x = b.add("relu", x, name=f"{prefix}_relu")
    x = b.add(
        "conv", x, name=f"{prefix}_conv", features=filters, kernel_size=1,
        use_bias=False,
    )
    return b.add("batch_norm", x, name=f"{prefix}_bn", eps=1e-3)


def _normal_cell(
    b: GraphBuilder, ip: str, p: str, filters: int, *, name: str
) -> str:
    """5-branch normal cell; concat of [p, x1..x5] -> 6*filters ch."""
    h = _squeeze(b, ip, filters, prefix=f"{name}_h")
    x1a = _sep_conv_block(b, h, filters, 5, prefix=f"{name}_left1")
    x1b = _sep_conv_block(b, p, filters, 3, prefix=f"{name}_right1")
    x1 = b.add("add", x1a, x1b, name=f"{name}_add1")
    x2a = _sep_conv_block(b, p, filters, 5, prefix=f"{name}_left2")
    x2b = _sep_conv_block(b, p, filters, 3, prefix=f"{name}_right2")
    x2 = b.add("add", x2a, x2b, name=f"{name}_add2")
    x3 = b.add(
        "avg_pool", h, name=f"{name}_left3", window=3, strides=1,
        padding="SAME",
    )
    x3 = b.add("add", x3, p, name=f"{name}_add3")
    x4a = b.add(
        "avg_pool", p, name=f"{name}_left4", window=3, strides=1,
        padding="SAME",
    )
    x4b = b.add(
        "avg_pool", p, name=f"{name}_right4", window=3, strides=1,
        padding="SAME",
    )
    x4 = b.add("add", x4a, x4b, name=f"{name}_add4")
    x5 = _sep_conv_block(b, h, filters, 3, prefix=f"{name}_left5")
    x5 = b.add("add", x5, h, name=f"{name}_add5")
    return b.add("concat", p, x1, x2, x3, x4, x5, name=name)


def _reduction_cell(
    b: GraphBuilder, ip: str, p: str, filters: int, *, name: str
) -> str:
    """Stride-2 cell; concat of [x2, x3, x4, x5] -> 4*filters ch."""
    h = _squeeze(b, ip, filters, prefix=f"{name}_h")
    x1a = _sep_conv_block(b, h, filters, 5, strides=2, prefix=f"{name}_left1")
    x1b = _sep_conv_block(b, p, filters, 7, strides=2, prefix=f"{name}_right1")
    x1 = b.add("add", x1a, x1b, name=f"{name}_add1")
    x2a = b.add(
        "max_pool", h, name=f"{name}_left2", window=3, strides=2,
        padding="SAME",
    )
    x2b = _sep_conv_block(b, p, filters, 7, strides=2, prefix=f"{name}_right2")
    x2 = b.add("add", x2a, x2b, name=f"{name}_add2")
    x3a = b.add(
        "avg_pool", h, name=f"{name}_left3", window=3, strides=2,
        padding="SAME",
    )
    x3b = _sep_conv_block(b, p, filters, 5, strides=2, prefix=f"{name}_right3")
    x3 = b.add("add", x3a, x3b, name=f"{name}_add3")
    x4 = b.add(
        "avg_pool", x1, name=f"{name}_left4", window=3, strides=1,
        padding="SAME",
    )
    x4 = b.add("add", x2, x4, name=f"{name}_add4")
    x5a = _sep_conv_block(b, x1, filters, 3, prefix=f"{name}_left5")
    x5b = b.add(
        "max_pool", h, name=f"{name}_right5", window=3, strides=2,
        padding="SAME",
    )
    x5 = b.add("add", x5a, x5b, name=f"{name}_add5")
    return b.add("concat", x2, x3, x4, x5, name=name)


def _build_nasnet(
    name: str,
    penultimate_filters: int,
    num_blocks: int,
    stem_filters: int,
    resolution: int,
    num_classes: int,
) -> Model:
    filters = penultimate_filters // 24
    b = GraphBuilder(name)
    x = b.input("input")
    x = b.add(
        "conv", x, name="stem_conv1", features=stem_filters, kernel_size=3,
        strides=2, padding="VALID", use_bias=False,
    )
    x = b.add("batch_norm", x, name="stem_bn1", eps=1e-3)
    cuts: list[str] = [x]

    # Track (node, channels, spatial-halvings) so _adjust knows whether p
    # needs the factorized reduction or just a channel projection. Each
    # inter-cell boundary carries the (cur, p) pair — collected as
    # multi-tensor cut bundles.
    pair_cuts: list[tuple[str, str]] = []

    def cell_chain():
        nonlocal x
        p, p_ch, p_lvl = None, stem_filters, 0
        cur, cur_ch, cur_lvl = x, stem_filters, 0

        def run(kind, f, cname):
            nonlocal p, p_ch, p_lvl, cur, cur_ch, cur_lvl
            adj = _adjust(
                b, p, cur, f,
                p_stride_mismatch=(p is not None and p_lvl < cur_lvl),
                p_channels=p_ch,
                prefix=cname,
            )
            prev, prev_ch, prev_lvl = cur, cur_ch, cur_lvl
            if kind == "normal":
                cur = _normal_cell(b, cur, adj, f, name=cname)
                cur_ch = 6 * f
            else:
                cur = _reduction_cell(b, cur, adj, f, name=cname)
                cur_ch, cur_lvl = 4 * f, cur_lvl + 1
            # p for the next cell is this cell's *input*; after _adjust,
            # its channel count is f (or unchanged when p was None).
            p, p_ch, p_lvl = prev, prev_ch, prev_lvl
            pair_cuts.append((cur, p))

        run("reduction", filters // 4, "stem_1")
        run("reduction", filters // 2, "stem_2")
        for i in range(num_blocks):
            run("normal", filters, f"cell_{i}")
        run("reduction", filters * 2, f"reduce_{num_blocks}")
        for i in range(num_blocks):
            run("normal", filters * 2, f"cell_{num_blocks + i + 1}")
        run("reduction", filters * 4, f"reduce_{2 * num_blocks}")
        for i in range(num_blocks):
            run("normal", filters * 4, f"cell_{2 * num_blocks + i + 1}")
        return cur

    x = cell_chain()
    # Every inter-cell boundary is a valid (cur, p) bundle; after the
    # final cell p is dropped, so that boundary is single-tensor.
    cuts.extend(pair_cuts[:-1])
    cuts.append(x)  # final cell's concat: its p companion is dropped here
    x = b.add("relu", x, name="final_relu")
    x = b.add("global_avg_pool", x, name="global_average_pooling2d")
    x = b.add("dense", x, name="predictions_dense", features=num_classes)
    x = b.add("softmax", x, name="predictions")
    return Model(
        name=name,
        graph=b.build(x),
        input_shape=(resolution, resolution, 3),
        cut_candidates=tuple(cuts),
    )


@register_model("nasnet_mobile")
def nasnet_mobile(num_classes: int = 1000) -> Model:
    return _build_nasnet("nasnet_mobile", 1056, 4, 32, 224, num_classes)


@register_model("nasnet_large")
def nasnet_large(num_classes: int = 1000) -> Model:
    return _build_nasnet("nasnet_large", 4032, 6, 96, 331, num_classes)
