"""Plain ResNet50 in float32 PyTorch: the benchmark's reference.

Written from He et al., "Deep Residual Learning for Image Recognition"
(arXiv:1512.03385, Table 1, the 50-layer column) as
`tf.keras.applications.ResNet50` lays it out, the model the original
DEFER partitions:

    zero pad 3 -> conv 7x7/2 -> BN -> relu -> zero pad 1 -> max pool 3x3/2
    -> 4 stages of [3, 4, 6, 3] bottlenecks (1x1, 3x3, 1x1 x4; the first
       block of a stage has a projection shortcut and, from stage 2 on,
       stride 2 on its first 1x1 conv, as Keras's v1 block does)
    -> global average pool -> dense 1000 -> softmax

Images are NHWC float32; convolution kernels are HWIO, dense kernels
[in, out], batch norms their raw (scale, bias, mean, var): the layouts
the benchmark draws and hands to both sides. The reference works out by
itself what the program derives from them: OIHW kernels for
`F.conv2d`, and each batch norm applied from its statistics.

Departures from the publication: none in the mathematics. The weights
are random (drawn by `param_specs`), so the outputs mean nothing as
classes. Batch norm eps is Keras's 1.001e-5.

`quantize` (a function applied to every conv and dense operand) is how
the control runs this model in a lower precision; None is float32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _blocks(cfg: dict):
    """(prefix, in width, filters, stride, projection) of each block,
    with the name of its residual sum, in order."""
    width = int(cfg["stem_features"])
    out = []
    add = 1
    for stage, (n, filters) in enumerate(
        zip(cfg["blocks_per_stage"], cfg["stage_widths"]), start=2
    ):
        for b in range(int(n)):
            first = b == 0
            stride = 2 if (first and stage > 2) else 1
            out.append((f"res{stage}{chr(ord('a') + b)}", width, int(filters),
                        stride, first, f"add_{add}"))
            width = int(filters) * int(cfg["expansion"])
            add += 1
    return out


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every weight as (name "<node>.<leaf>", shape, init kind), in the
    order the benchmark draws them. Kinds (`weights.py`): "he" normal
    conv kernels, "dense" kernels, "bias", and the batch norm leaves
    "bn_scale", "bn_scale_last" (the last norm of a residual branch),
    "bn_bias", "bn_mean", "bn_var"."""
    specs: list[tuple[str, tuple[int, ...], str]] = []
    exp = int(cfg["expansion"])

    def conv_bn(prefix, k, cin, cout, last=False):
        specs.append((f"{prefix}_conv.kernel", (k, k, cin, cout), "he"))
        for leaf, kind in (("scale", "bn_scale_last" if last else "bn_scale"),
                           ("bias", "bn_bias"), ("mean", "bn_mean"),
                           ("var", "bn_var")):
            specs.append((f"{prefix}_bn.{leaf}", (cout,), kind))

    stem = int(cfg["stem_features"])
    conv_bn("conv1", int(cfg["stem_kernel"]), int(cfg["channels"]), stem)
    for prefix, cin, f, _stride, proj, _add in _blocks(cfg):
        if proj:
            conv_bn(f"{prefix}_proj", 1, cin, f * exp)
        conv_bn(f"{prefix}_a", 1, cin, f)
        conv_bn(f"{prefix}_b", 3, f, f)
        conv_bn(f"{prefix}_c", 1, f, f * exp, last=True)
    feat = int(cfg["stage_widths"][-1]) * exp
    specs.append(("fc.kernel", (feat, int(cfg["num_classes"])), "dense"))
    specs.append(("fc.bias", (int(cfg["num_classes"]),), "bias"))
    return specs


def _conv(x, kernel, stride, padding, q):
    w = kernel.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(x, p, name, eps):
    scale, bias = p[f"{name}.scale"].float(), p[f"{name}.bias"].float()
    mean, var = p[f"{name}.mean"].float(), p[f"{name}.var"].float()
    inv = scale / torch.sqrt(var + eps)
    return (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]


def forward(
    cfg: dict,
    params: dict[str, torch.Tensor],
    images: torch.Tensor,
    quantize: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Class probabilities [B, classes] of NHWC images, in float32."""
    eps = float(cfg["bn_eps"])
    q = quantize
    x = images.float().permute(0, 3, 1, 2)  # NCHW
    k = int(cfg["stem_kernel"])
    x = F.pad(x, (k // 2,) * 4)
    x = _conv(x, params["conv1_conv.kernel"], 2, 0, q)
    x = F.relu(_bn(x, params, "conv1_bn", eps))
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
    for prefix, _cin, _f, stride, proj, _add in _blocks(cfg):
        short = x
        if proj:
            short = _bn(_conv(x, params[f"{prefix}_proj_conv.kernel"], stride,
                              0, q), params, f"{prefix}_proj_bn", eps)
        y = _conv(x, params[f"{prefix}_a_conv.kernel"], stride, 0, q)
        y = F.relu(_bn(y, params, f"{prefix}_a_bn", eps))
        y = _conv(y, params[f"{prefix}_b_conv.kernel"], 1, 1, q)
        y = F.relu(_bn(y, params, f"{prefix}_b_bn", eps))
        y = _conv(y, params[f"{prefix}_c_conv.kernel"], 1, 0, q)
        y = _bn(y, params, f"{prefix}_c_bn", eps)
        x = F.relu(y + short)
    x = x.mean(dim=(2, 3))
    w = params["fc.kernel"].float()
    if q is not None:
        x, w = q(x), q(w)
    logits = x @ w + params["fc.bias"].float()
    return torch.softmax(logits, dim=-1)
