"""Transformer ops (counterpart of `defer_tpu/ops/transformer.py`).

Attention routes through `defer_tpu_torch.ops.attention`, which takes
the hand-written flash kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from defer_tpu_torch.ops.library import _normal, dense
from defer_tpu_torch.ops.registry import register_op


def _embedding_init(gen, attrs, in_shapes, param_dtype):
    vocab = int(attrs["vocab_size"])
    dim = int(attrs["features"])
    return {"table": _normal(gen, (vocab, dim), param_dtype, 0.02)}


@register_op("embedding", init=_embedding_init)
def embedding_apply(params, inputs, attrs):
    (ids,) = inputs
    return F.embedding(ids, params["table"])


def _pos_embedding_init(gen, attrs, in_shapes, param_dtype):
    max_len = int(attrs["max_len"])
    dim = in_shapes[0][-1]
    return {"table": _normal(gen, (max_len, dim), param_dtype, 0.02)}


@register_op("pos_embedding", init=_pos_embedding_init)
def pos_embedding_apply(params, inputs, attrs):
    """Adds a learned positional embedding to (B, S, D)."""
    (x,) = inputs
    seq = x.shape[1]
    return x + params["table"][:seq].to(x.dtype)


def _layer_norm_init(gen, attrs, in_shapes, param_dtype):
    dim = in_shapes[0][-1]
    return {
        "scale": torch.ones((dim,), dtype=param_dtype, device=gen.device),
        "bias": torch.zeros((dim,), dtype=param_dtype, device=gen.device),
    }


@register_op("layer_norm", init=_layer_norm_init)
def layer_norm_apply(params, inputs, attrs):
    """Layer norm in f32 (biased variance, eps 1e-12 by default), cast
    back to x's dtype — the JAX op's arithmetic in one fused call."""
    (x,) = inputs
    eps = float(attrs.get("eps", 1e-12))
    out = F.layer_norm(
        x.float(),
        (x.shape[-1],),
        params["scale"].float(),
        params["bias"].float(),
        eps,
    )
    return out.to(x.dtype)


def _mha_init(gen, attrs, in_shapes, param_dtype):
    dim = in_shapes[0][-1]
    num_heads = int(attrs["num_heads"])
    if dim % num_heads:
        raise ValueError(f"model dim {dim} not divisible by {num_heads} heads")
    std = dim**-0.5
    params = {
        w: _normal(gen, (dim, dim), param_dtype, std)
        for w in ("wq", "wk", "wv", "wo")
    }
    for b in ("bq", "bk", "bv", "bo"):
        params[b] = torch.zeros((dim,), dtype=param_dtype, device=gen.device)
    return params


@register_op("mha", init=_mha_init)
def mha_apply(params, inputs, attrs):
    """Multi-head self-attention on (B, S, D).

    Optional second input: additive attention bias/mask broadcastable to
    (B, heads, S, S). The JAX graph's `use_pallas` attr has no meaning
    here: the kernel is chosen by the tensor's device.
    """
    from defer_tpu_torch.ops.attention import multi_head_attention

    x = inputs[0]
    mask = inputs[1] if len(inputs) > 1 else None
    q = dense(x, params["wq"], params["bq"])
    k = dense(x, params["wk"], params["bk"])
    v = dense(x, params["wv"], params["bv"])
    out = multi_head_attention(
        q,
        k,
        v,
        num_heads=int(attrs["num_heads"]),
        bias=mask,
        causal=bool(attrs.get("causal", False)),
    )
    return dense(out, params["wo"], params["bo"])


@register_op("take_token")
def take_token_apply(params, inputs, attrs):
    """Select one sequence position, e.g. the [CLS] token: (B,S,D)->(B,D)."""
    (x,) = inputs
    return x[:, int(attrs.get("index", 0)), :]


def _cls_token_init(gen, attrs, in_shapes, param_dtype):
    dim = in_shapes[0][-1]
    return {"token": _normal(gen, (1, 1, dim), param_dtype, 0.02)}


@register_op("cls_token", init=_cls_token_init)
def cls_token_apply(params, inputs, attrs):
    """Prepend a learned classification token: (B,S,D) -> (B,S+1,D)."""
    (x,) = inputs
    tok = params["token"].to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    return torch.cat([tok, x], dim=1)
