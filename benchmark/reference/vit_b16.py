"""Plain ViT-B/16 in float32 PyTorch: the benchmark's reference.

Written from Dosovitskiy et al., "An Image is Worth 16x16 Words"
(arXiv:2010.11929, section 3.1 and Table 1, ViT-Base) with the sizes of
`google/vit-base-patch16-224`:

    16x16 stride-16 patch projection -> 196 tokens -> [class] token
    prepended -> learned position embedding (197 x 768)
    -> 12 pre-LN blocks: x += MHA(LN(x)); x += MLP(LN(x)), MLP 768 ->
       3072 -> GELU -> 768, 12 heads of 64, softmax(q k^T / 8) v
    -> final LN -> the [class] token -> dense 1000 (logits)

Images are NHWC float32; the patch kernel is HWIO, dense kernels
[in, out]. The result is the logits, the model's output.

Departures from the publication, each the program's and followed here
so that both compute one function: the patch projection has no bias;
GELU is the tanh approximation (the paper's code uses the exact erf
form); layer norm eps is 1e-12 (`google/vit-base-patch16-224`'s config,
where the paper's code uses 1e-6).

`quantize` (a function applied to every matrix-product operand,
attention's included) is how the control runs this model in a lower
precision; None is float32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def _tokens(cfg: dict) -> int:
    return (int(cfg["image_size"]) // int(cfg["patch_size"])) ** 2 + 1


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every weight as (name "<node>.<leaf>", shape, init kind), in the
    order the benchmark draws them (kinds: see `weights.py`)."""
    d, f, p = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(
        cfg["patch_size"])
    specs = [
        ("patch_embed.kernel", (p, p, int(cfg["num_channels"]), d), "he"),
        ("class_token.token", (1, 1, d), "embed"),
        ("position_embedding.table", (_tokens(cfg), d), "embed"),
    ]
    for i in range(int(cfg["num_hidden_layers"])):
        b = f"block_{i}"
        specs += [(f"{b}_ln1.scale", (d,), "ln_scale"),
                  (f"{b}_ln1.bias", (d,), "bias")]
        for w in ("q", "k", "v", "o"):
            specs.append((f"{b}_mha.w{w}", (d, d), "dense"))
        for w in ("q", "k", "v", "o"):
            specs.append((f"{b}_mha.b{w}", (d,), "bias"))
        specs += [(f"{b}_ln2.scale", (d,), "ln_scale"),
                  (f"{b}_ln2.bias", (d,), "bias"),
                  (f"{b}_mlp_in.kernel", (d, f), "dense"),
                  (f"{b}_mlp_in.bias", (f,), "bias"),
                  (f"{b}_mlp_out.kernel", (f, d), "dense"),
                  (f"{b}_mlp_out.bias", (d,), "bias")]
    specs += [("final_ln.scale", (d,), "ln_scale"),
              ("final_ln.bias", (d,), "bias"),
              ("head.kernel", (d, int(cfg["num_labels"])), "dense"),
              ("head.bias", (int(cfg["num_labels"]),), "bias")]
    return specs


def forward(
    cfg: dict,
    params: dict[str, torch.Tensor],
    images: torch.Tensor,
    quantize: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Logits [B, labels] of NHWC images, in float32."""
    q = quantize or (lambda t: t)
    eps = float(cfg["layer_norm_eps"])
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    p = int(cfg["patch_size"])
    dh = d // h

    def w(name):
        return params[name].float()

    def lin(x, name):
        return q(x) @ q(w(f"{name}.kernel")) + w(f"{name}.bias")

    def ln(x, name):
        return F.layer_norm(x, (d,), w(f"{name}.scale"), w(f"{name}.bias"),
                            eps)

    b = images.shape[0]
    x = images.float().permute(0, 3, 1, 2)
    kern = w("patch_embed.kernel").permute(3, 2, 0, 1)
    x = F.conv2d(q(x), q(kern), stride=p)  # [B, D, 14, 14]
    x = x.flatten(2).transpose(1, 2)  # [B, 196, D], row-major patches
    cls = w("class_token.token").expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + w("position_embedding.table")
    s = x.shape[1]
    for i in range(int(cfg["num_hidden_layers"])):
        blk = f"block_{i}"
        y = ln(x, f"{blk}_ln1")
        qkv = [q(y) @ q(w(f"{blk}_mha.w{n}")) + w(f"{blk}_mha.b{n}")
               for n in ("q", "k", "v")]
        qh, kh, vh = (t.view(b, s, h, dh).transpose(1, 2) for t in qkv)
        att = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(dh),
                            dim=-1)
        o = (q(att) @ q(vh)).transpose(1, 2).reshape(b, s, d)
        x = x + q(o) @ q(w(f"{blk}_mha.wo")) + w(f"{blk}_mha.bo")
        y = ln(x, f"{blk}_ln2")
        y = F.gelu(lin(y, f"{blk}_mlp_in"), approximate="tanh")
        x = x + lin(y, f"{blk}_mlp_out")
    x = ln(x, "final_ln")[:, 0]
    return lin(x, "head")
