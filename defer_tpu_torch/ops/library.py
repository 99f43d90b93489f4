"""The standard op library (counterpart of `defer_tpu/ops/library.py`):
conv, depthwise and separable conv, dense, batch norm, pools, pad and
crop, merges, activations and Keras normalization.

Parameters keep the JAX package's layouts (HWIO conv kernels, HW1C
depthwise kernels, [cin, cout] dense kernels), so a param tree maps 1:1
between the packages. Activations are NHWC at every node. The convs and
pools run through `torch.nn.functional` (cuDNN on the card) on the NCHW
view `x.permute(0, 3, 1, 2)`, which is channels-last in memory, so no
activation is copied; permuting the result back gives NHWC again.

A stage stores each conv kernel physically in O,H,W,I order behind its
logical HWIO shape (`_conv_place`), so the OIHW view cuDNN takes is
channels-last too and no call copies a weight; and it folds each batch
norm's statistics into one scale and shift (`_bn_place`).

All shape math lives in the `apply` functions; the IR derives shapes
from them by running them on meta tensors (graph/ir.py), so there is
one source of truth.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from defer_tpu_torch.ops.registry import register_op


def _normal(gen, shape, dtype, std: float) -> torch.Tensor:
    """N(0, std^2) draws from `gen`, on the generator's device."""
    return torch.randn(
        shape, generator=gen, device=gen.device, dtype=dtype
    ) * std


def dense(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """x @ kernel (+ bias) over the last dim, kernel [cin, cout], in x's
    dtype; the bias rides the product's epilogue (addmm)."""
    w = kernel.to(x.dtype)
    if bias is None:
        return x @ w
    out = torch.addmm(bias.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return out.view(*x.shape[:-1], w.shape[1])


def _dense_init(gen, attrs, in_shapes, param_dtype):
    cin = in_shapes[0][-1]
    cout = int(attrs["features"])
    params = {
        "kernel": _normal(gen, (cin, cout), param_dtype, math.sqrt(1.0 / cin))
    }
    if attrs.get("use_bias", True):
        params["bias"] = torch.zeros(
            (cout,), dtype=param_dtype, device=gen.device
        )
    return params


@register_op("dense", init=_dense_init)
def dense_apply(params, inputs, attrs):
    (x,) = inputs
    return dense(x, params["kernel"], params.get("bias"))


# --------------------------------------------------------------------------
# conv / batch norm
# --------------------------------------------------------------------------


def _pair(v: Any) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return (int(a), int(b))
    return (int(v), int(v))


def _same_pads(size: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial dim: the total pad makes
    ceil(size / s) outputs; `total // 2` goes before, the rest after (so
    a stride-2 window may pad (0, 1))."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding: Any, hw, window, strides, dilation=(1, 1)):
    """A padding attr ("SAME", "VALID" or explicit ((t, b), (l, r))) as
    ((top, bottom), (left, right)) for this input."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        return tuple(
            _same_pads(n, k, s, d)
            for n, k, s, d in zip(hw, window, strides, dilation)
        )
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def _nhwc_pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = pads
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _conv(x, kernel, strides, padding, dilation, groups) -> torch.Tensor:
    """NHWC x HWIO -> NHWC through F.conv2d on channels-last views.

    Symmetric padding goes to the conv itself; only an asymmetric pad
    (a strided SAME conv at some sizes) costs an F.pad first."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    (t, b), (l, r) = _pads(
        padding, x.shape[1:3], (kh, kw), strides, dilation
    )
    if t != b or l != r:
        x = _nhwc_pad(x, ((t, b), (l, r)))
        t = l = 0
    out = F.conv2d(
        x.permute(0, 3, 1, 2),
        kernel.to(x.dtype).permute(3, 2, 0, 1),
        stride=strides,
        padding=(t, l),
        dilation=dilation,
        groups=groups,
    )
    return out.permute(0, 2, 3, 1)


def _bias(out: torch.Tensor, params) -> torch.Tensor:
    if "bias" in params:
        out = out + params["bias"].to(out.dtype)
    return out


def _conv_init(gen, attrs, in_shapes, param_dtype):
    kh, kw = _pair(attrs.get("kernel_size", 3))
    cin = in_shapes[0][-1]
    groups = int(attrs.get("groups", 1))
    cout = int(attrs["features"])
    fan_in = kh * kw * (cin // groups)
    params = {
        "kernel": _normal(
            gen, (kh, kw, cin // groups, cout), param_dtype,
            math.sqrt(2.0 / fan_in),
        )
    }
    if attrs.get("use_bias", False):
        params["bias"] = torch.zeros(
            (cout,), dtype=param_dtype, device=gen.device
        )
    return params


def _ohwi(kernel: torch.Tensor) -> torch.Tensor:
    """The same HWIO tensor stored in O,H,W,I order: its OIHW view
    `permute(3, 2, 0, 1)` is then channels-last, as cuDNN takes it."""
    return kernel.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _conv_place(params, attrs, compute_dtype):
    del attrs, compute_dtype
    return {
        k: _ohwi(v) if k in ("kernel", "dw_kernel", "pw_kernel") else v
        for k, v in params.items()
    }


@register_op("conv", init=_conv_init, place=_conv_place)
def conv_apply(params, inputs, attrs):
    (x,) = inputs
    out = _conv(
        x,
        params["kernel"],
        _pair(attrs.get("strides", 1)),
        attrs.get("padding", "SAME"),
        _pair(attrs.get("dilation", 1)),
        int(attrs.get("groups", 1)),
    )
    return _bias(out, params)


def _depthwise_init(gen, attrs, in_shapes, param_dtype):
    kh, kw = _pair(attrs.get("kernel_size", 3))
    cin = in_shapes[0][-1]
    mult = int(attrs.get("depth_multiplier", 1))
    params = {
        "kernel": _normal(
            gen, (kh, kw, 1, cin * mult), param_dtype,
            math.sqrt(2.0 / (kh * kw)),
        )
    }
    if attrs.get("use_bias", False):
        params["bias"] = torch.zeros(
            (cin * mult,), dtype=param_dtype, device=gen.device
        )
    return params


@register_op("depthwise_conv", init=_depthwise_init, place=_conv_place)
def depthwise_conv_apply(params, inputs, attrs):
    """One group per input channel; with depth_multiplier m, output
    channel o reads input channel o // m (XLA's feature_group_count)."""
    (x,) = inputs
    out = _conv(
        x,
        params["kernel"],
        _pair(attrs.get("strides", 1)),
        attrs.get("padding", "SAME"),
        _pair(attrs.get("dilation", 1)),
        x.shape[-1],
    )
    return _bias(out, params)


def _separable_init(gen, attrs, in_shapes, param_dtype):
    kh, kw = _pair(attrs.get("kernel_size", 3))
    cin = in_shapes[0][-1]
    mult = int(attrs.get("depth_multiplier", 1))
    cout = int(attrs["features"])
    params = {
        "dw_kernel": _normal(
            gen, (kh, kw, 1, cin * mult), param_dtype,
            math.sqrt(2.0 / (kh * kw)),
        ),
        "pw_kernel": _normal(
            gen, (1, 1, cin * mult, cout), param_dtype,
            math.sqrt(2.0 / (cin * mult)),
        ),
    }
    if attrs.get("use_bias", True):
        params["bias"] = torch.zeros(
            (cout,), dtype=param_dtype, device=gen.device
        )
    return params


@register_op("separable_conv", init=_separable_init, place=_conv_place)
def separable_conv_apply(params, inputs, attrs):
    """Depthwise kxk then pointwise 1x1 as one op (Keras
    SeparableConv2D); the bias comes after both."""
    (x,) = inputs
    out = _conv(
        x,
        params["dw_kernel"],
        _pair(attrs.get("strides", 1)),
        attrs.get("padding", "SAME"),
        _pair(attrs.get("dilation", 1)),
        x.shape[-1],
    )
    out = _conv(out, params["pw_kernel"], (1, 1), "VALID", (1, 1), 1)
    return _bias(out, params)


def _bn_init(gen, attrs, in_shapes, param_dtype):
    c = in_shapes[0][-1]
    ones = torch.ones((c,), dtype=param_dtype, device=gen.device)
    zeros = torch.zeros((c,), dtype=param_dtype, device=gen.device)
    return {"scale": ones, "bias": zeros, "mean": zeros.clone(),
            "var": ones.clone()}


def _bn_fold(params, eps: float, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as one multiply-add: scale and shift formed in f32,
    then cast to the activation's dtype, as the JAX op rounds them."""
    gamma = params["scale"].float()
    inv = torch.rsqrt(params["var"].float() + eps)
    # The JAX op's order of products, so the f32 values match too.
    shift = params["bias"].float() - params["mean"].float() * gamma * inv
    return (gamma * inv).to(dtype), shift.to(dtype)


def _bn_place(params, attrs, compute_dtype):
    scale, shift = _bn_fold(
        params, float(attrs.get("eps", 1e-3)), compute_dtype
    )
    return {"folded_scale": scale, "folded_shift": shift}


@register_op("batch_norm", init=_bn_init, place=_bn_place)
def batch_norm_apply(params, inputs, attrs):
    """Inference-mode BN with stored statistics: x * scale + shift in one
    launch (addcmul); a placed stage's params already hold the fold."""
    (x,) = inputs
    if "folded_scale" in params:
        scale = params["folded_scale"].to(x.dtype)
        shift = params["folded_shift"].to(x.dtype)
    else:
        scale, shift = _bn_fold(params, float(attrs.get("eps", 1e-3)), x.dtype)
    return torch.addcmul(shift, x, scale)


# --------------------------------------------------------------------------
# pooling / padding / reshaping
# --------------------------------------------------------------------------


def _pool_dims(attrs):
    """(window, strides, padding attr) of a pool; strides default to the
    window and padding to VALID, as in the JAX op."""
    window = _pair(attrs.get("window", 2))
    strides = _pair(attrs.get("strides", attrs.get("window", 2)))
    return window, strides, attrs.get("padding", "VALID")


def _pool_pads(x, attrs):
    window, strides, padding = _pool_dims(attrs)
    return window, strides, _pads(padding, x.shape[1:3], window, strides)


def _symmetric_within_half(pads, window) -> bool:
    """F.max_pool2d / F.avg_pool2d pad only symmetrically, by at most
    half the window."""
    return all(
        lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, window)
    )


@register_op("max_pool")
def max_pool_apply(params, inputs, attrs):
    """Max over windows; padding counts as -inf (never the max)."""
    (x,) = inputs
    window, strides, pads = _pool_pads(x, attrs)
    if _symmetric_within_half(pads, window):
        pad = (pads[0][0], pads[1][0])
    else:
        x = _nhwc_pad(x, pads, value=float("-inf"))
        pad = (0, 0)
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides, pad)
    return out.permute(0, 2, 3, 1)


@register_op("avg_pool")
def avg_pool_apply(params, inputs, attrs):
    """Average pool that excludes padding from the count (TF semantics,
    which the Keras models rely on for SAME-padded pools):
    `count_include_pad=False` where the padding is symmetric, else a
    zero pad, window sums, and division by the count of real elements
    in each window."""
    (x,) = inputs
    window, strides, pads = _pool_pads(x, attrs)
    if _symmetric_within_half(pads, window):
        out = F.avg_pool2d(
            x.permute(0, 3, 1, 2), window, strides,
            (pads[0][0], pads[1][0]), count_include_pad=False,
        )
        return out.permute(0, 2, 3, 1)
    summed = F.avg_pool2d(
        _nhwc_pad(x, pads).permute(0, 3, 1, 2), window, strides,
        divisor_override=1,
    )
    ones = torch.ones((1, *x.shape[1:3], 1), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(
        _nhwc_pad(ones, pads).permute(0, 3, 1, 2), window, strides,
        divisor_override=1,
    )
    return (summed / counts).permute(0, 2, 3, 1)


@register_op("global_avg_pool")
def global_avg_pool_apply(params, inputs, attrs):
    (x,) = inputs
    return x.mean(dim=(1, 2), keepdim=bool(attrs.get("keepdims", False)))


@register_op("global_max_pool")
def global_max_pool_apply(params, inputs, attrs):
    (x,) = inputs
    return x.amax(dim=(1, 2), keepdim=bool(attrs.get("keepdims", False)))


@register_op("zero_pad")
def zero_pad_apply(params, inputs, attrs):
    (x,) = inputs
    (pt, pb), (pl, pr) = attrs["padding"]
    return _nhwc_pad(x, ((int(pt), int(pb)), (int(pl), int(pr))))


@register_op("crop")
def crop_apply(params, inputs, attrs):
    (x,) = inputs
    (ct, cb), (cl, cr) = attrs["cropping"]
    h, w = x.shape[1], x.shape[2]
    return x[:, ct : h - cb, cl : w - cr, :]



@register_op("flatten")
def flatten_apply(params, inputs, attrs):
    (x,) = inputs
    return x.reshape(x.shape[0], -1)


@register_op("reshape")
def reshape_apply(params, inputs, attrs):
    (x,) = inputs
    return x.reshape((x.shape[0], *attrs["shape"]))


@register_op("identity")
def identity_apply(params, inputs, attrs):
    (x,) = inputs
    return x


# Dropout at inference time is the identity.
@register_op("dropout")
def dropout_apply(params, inputs, attrs):
    (x,) = inputs
    return x


# --------------------------------------------------------------------------
# merges
# --------------------------------------------------------------------------


@register_op("add")
def add_apply(params, inputs, attrs):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return out


@register_op("multiply")
def multiply_apply(params, inputs, attrs):
    out = inputs[0]
    for x in inputs[1:]:
        out = out * x
    return out


@register_op("concat")
def concat_apply(params, inputs, attrs):
    return torch.cat(list(inputs), dim=int(attrs.get("axis", -1)))


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------


@register_op("relu")
def relu_apply(params, inputs, attrs):
    return F.relu(inputs[0])


@register_op("relu6")
def relu6_apply(params, inputs, attrs):
    return F.relu6(inputs[0])


@register_op("sigmoid")
def sigmoid_apply(params, inputs, attrs):
    return torch.sigmoid(inputs[0])


@register_op("tanh")
def tanh_apply(params, inputs, attrs):
    return torch.tanh(inputs[0])


@register_op("swish")
def swish_apply(params, inputs, attrs):
    return F.silu(inputs[0])


@register_op("gelu")
def gelu_apply(params, inputs, attrs):
    # approximate=True is jax.nn.gelu's tanh form.
    approximate = bool(attrs.get("approximate", True))
    return F.gelu(inputs[0], approximate="tanh" if approximate else "none")


@register_op("softmax")
def softmax_apply(params, inputs, attrs):
    return F.softmax(inputs[0], dim=int(attrs.get("axis", -1)))


@register_op("scale")
def scale_apply(params, inputs, attrs):
    """x * constant (InceptionResNetV2 residual scaling)."""
    return inputs[0] * float(attrs["value"])


@register_op("rescale")
def rescale_apply(params, inputs, attrs):
    """x * scale + offset (Keras Rescaling)."""
    return inputs[0] * float(attrs.get("scale", 1.0)) + float(
        attrs.get("offset", 0.0)
    )


def _normalization_init(gen, attrs, in_shapes, param_dtype):
    if attrs.get("mean") is not None:
        return {}  # statistics baked into attrs, nothing to learn/load
    c = in_shapes[0][-1]
    return {
        "mean": torch.zeros((c,), dtype=param_dtype, device=gen.device),
        "var": torch.ones((c,), dtype=param_dtype, device=gen.device),
    }


@register_op("normalization", init=_normalization_init)
def normalization_apply(params, inputs, attrs):
    """Keras Normalization (adapted feature scaling):
    (x - mean) / max(sqrt(var), eps) in f32, eps = Keras's 1e-7."""
    (x,) = inputs
    if "mean" in params:
        mean, var = params["mean"].float(), params["var"].float()
    else:
        mean = torch.tensor(attrs["mean"], dtype=torch.float32,
                            device=x.device)
        var = torch.tensor(attrs["variance"], dtype=torch.float32,
                           device=x.device)
    denom = torch.clamp(torch.sqrt(var), min=1e-7)
    return ((x.float() - mean) / denom).to(x.dtype)
