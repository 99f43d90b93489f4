"""Weight-only int8 quantization for decode serving (w8a16).

Counterpart of `defer_tpu/models/quant.py`. A quantized leaf is
`{"q": int8[..., out], "s": f32 broadcastable to q}`: symmetric,
per-output-channel scales, kept per layer (L leading on both) for
stacked matrices, so slicing a layer slices q and s together. The
decoder widens a leaf where it uses it (`dequantize_leaf`); unlike
XLA, eager PyTorch does not fuse that widening into the matrix
product, so each use reads the int8 weight and writes a widened copy.
"""

from __future__ import annotations

from typing import Any

import torch

#: stack matrices worth quantizing (biases/norm scales are tiny).
DEFAULT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_symmetric(x: torch.Tensor, axis=None, *, keepdims: bool = False):
    """q = clip(round(x / s), -127, 127) with s = max|x| / 127 reduced
    over `axis` (None = per-tensor). Degenerate scales (an all-zero
    input, or an amax so small that amax/127 underflows to 0) clamp to
    1.0, so the tensor quantizes to zeros. Returns (q, s); with
    keepdims=False the scale drops the reduced axes. The wire codec
    (runtime/codec.py) quantizes through this in float64."""
    xf = x if x.is_floating_point() else x.float()
    if axis is None:
        red = tuple(range(xf.ndim))
    else:
        axes = (axis,) if isinstance(axis, int) else axis
        red = tuple(a % xf.ndim for a in axes)
    if xf.numel():
        amax = xf.abs().amax(dim=red, keepdim=True)
    else:  # an empty tensor (a codec edge case): amax would raise
        amax = xf.new_zeros(
            [1 if i in red else d for i, d in enumerate(xf.shape)]
        )
    s = amax / 127.0
    s = torch.where(s > 0.0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    if not keepdims:
        for a in sorted(red, reverse=True):
            s = s.squeeze(a)
    return q, s


def dequantize_symmetric(q, s, dtype: Any = torch.float32):
    """Inverse of quantize_symmetric: widen q and fold the scale back
    in, the multiply in `dtype`. `s` must broadcast to `q`."""
    return q.to(dtype) * s.to(dtype)


def quantize_leaf(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over the contraction axes; the
    scale keeps broadcastable (keepdims) shape, and layer-stacked
    [L, in, out] matrices get per-layer channel scales with L leading."""
    wf = w.float()
    red = (
        tuple(range(1, wf.ndim - 1))
        if wf.ndim >= 3
        else tuple(range(wf.ndim - 1))
    )
    q, s = quantize_symmetric(wf, axis=red, keepdims=True)
    return {"q": q, "s": s.float()}


def dequantize_leaf(leaf: Any, dtype: Any) -> torch.Tensor:
    """Widen {"q","s"} back to `dtype`; plain tensors pass through
    (cast, a no-op when the dtype already matches), so call sites handle
    mixed quantized/plain trees with one helper."""
    if isinstance(leaf, dict) and "q" in leaf:
        return dequantize_symmetric(leaf["q"], leaf["s"], dtype)
    return leaf.to(dtype)


def quantize_decoder_params(
    params: dict, *, keys: tuple[str, ...] = DEFAULT_KEYS
) -> dict:
    """Quantize a GptDecoder/llama param tree for serving: the stack's
    matmul weights plus the embedding / untied head. Norm scales,
    biases and positions stay in their float dtype."""
    out = dict(params)
    out["stack"] = {
        k: quantize_leaf(v) if k in keys else v
        for k, v in params["stack"].items()
    }
    out["token_embedding"] = quantize_leaf(params["token_embedding"])
    if "lm_head" in params:
        out["lm_head"] = quantize_leaf(params["lm_head"])
    return out


def quantization_error(w: torch.Tensor) -> float:
    """Max relative reconstruction error of quantize_leaf on `w`."""
    back = dequantize_leaf(quantize_leaf(w), torch.float32)
    denom = torch.clamp(w.float().abs().max(), min=1e-12)
    return float((back - w.float()).abs().max() / denom)
