"""Dense and elementwise ops of the standard library (counterpart of
`defer_tpu/ops/library.py`).

Parameters keep the JAX package's layouts (`dense` kernels are
[cin, cout]), so a param tree maps 1:1 between the packages. All shape
math lives in the `apply` functions; the IR derives shapes from them by
running them on meta tensors (graph/ir.py), so there is one source of
truth. The conv / pool / batch-norm family joins with the CNN zoo.
"""

from __future__ import annotations

import math

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
# reshaping
# --------------------------------------------------------------------------


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
