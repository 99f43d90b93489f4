"""The transformer stack's config, parameters and per-token helpers, as
the KV-cache decoder (`models/gpt.py`) uses them.

Counterpart of a subset of `defer_tpu/parallel/transformer_stack.py`:
`TransformerConfig` with every field and validation, `init_stack` for
the dense path, `embed_lookup` (one device, int8 tables included), the
norms with f32 statistics, and rotary embeddings. Parameters are plain
nested dicts of tensors with a leading [L] layer axis, keyed as the JAX
package keys them, so `weights.params_from_jax` maps one tree onto the
other.

Not ported yet: the mixture-of-experts FFN, LoRA adapter factors, the
SPMD encoder stack and its partition specs (ROADMAP Queue 1 item 7).
`init_stack` raises `NotImplementedError` for a config that asks for
experts or adapters.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    vocab_size: int = 30522
    max_len: int = 512
    layer_norm_eps: float = 1e-12
    # > 0 switches every block's FFN to a routed mixture of experts.
    num_experts: int = 0
    # "post" = BERT-style residual-then-norm; "pre" = GPT-style
    # norm-then-sublayer.
    norm_style: str = "post"
    # Causal (decoder-style) attention masking.
    causal: bool = False
    # Sliding-window (Mistral-style) causal attention: each position
    # attends at most `window` predecessors. None = full causal.
    window: int | None = None
    remat: bool = False
    moe_dispatch: str = "dense"
    capacity_factor: float = 1.25
    moe_top_k: int = 1
    # -- llama-family knobs -------------------------------------------
    # Grouped-query attention: K/V project to this many heads. None = MHA.
    num_kv_heads: int | None = None
    norm_type: str = "layer"  # "layer" | "rms"
    ffn_style: str = "gelu"  # "gelu" | "swiglu"
    pos_style: str = "learned"  # "learned" table | "rope"
    use_bias: bool = True
    rope_theta: float = 10000.0
    # -- LoRA ---------------------------------------------------------
    lora_rank: int = 0
    lora_targets: tuple = ("wq", "wv")
    lora_alpha: float | None = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def __post_init__(self):
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads={self.kv_heads} must divide "
                f"num_heads={self.num_heads}"
            )
        if self.ffn_style == "swiglu" and self.num_experts:
            raise ValueError("swiglu MoE blocks are not supported")
        if self.window is not None and (
            self.window < 1 or not self.causal
        ):
            raise ValueError(
                f"window={self.window} needs causal=True and window >= 1"
            )
        if self.capacity_factor <= 0:
            raise ValueError(
                f"capacity_factor={self.capacity_factor} must be > 0 "
                "(non-positive values would silently drop almost every "
                "token to the residual path)"
            )
        if self.num_experts and not (
            1 <= self.moe_top_k <= self.num_experts
        ):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in "
                f"[1, num_experts={self.num_experts}]"
            )
        if self.lora_rank:
            if self.lora_rank < 1:
                raise ValueError(f"lora_rank={self.lora_rank} must be >= 1")
            valid = {"wq", "wk", "wv", "wo", "w1", "w2"}
            if self.ffn_style == "swiglu":
                valid.add("w3")
            if self.num_experts:
                valid -= {"w1", "w2"}
            bad = set(self.lora_targets) - valid
            if bad:
                raise ValueError(
                    f"lora_targets {sorted(bad)} not adaptable for this "
                    f"config (valid: {sorted(valid)})"
                )
            if not self.lora_targets:
                raise ValueError("lora_rank set but lora_targets is empty")
        for field, allowed in (
            ("norm_style", ("post", "pre")),
            ("norm_type", ("layer", "rms")),
            ("ffn_style", ("gelu", "swiglu")),
            ("pos_style", ("learned", "rope")),
            ("moe_dispatch", ("dense", "a2a")),
        ):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"{field}={v!r}: must be one of {allowed}"
                )


def normal(gen, shape, scale, dtype=torch.float32, device=None):
    """scale * N(0, 1) draws of `shape` from `gen`, on `device` (the
    generator's own when None)."""
    return torch.randn(
        shape, generator=gen, dtype=dtype, device=device or gen.device
    ).mul_(scale)


def init_stack(
    generator: torch.Generator,
    cfg: TransformerConfig,
    dtype: Any = torch.float32,
    device: torch.device | str | None = None,
) -> dict:
    """Parameters for L stacked dense blocks, leading axis = layer, drawn
    from `generator` on `device` (the generator's own device when None).

    The key set follows the config as in the JAX package: GQA narrows
    wk/wv to the KV head width, use_bias=False drops every b*,
    norm_type="rms" drops the norm biases, and ffn_style="swiglu" adds
    the w3 up-projection. The draws have the JAX package's
    distributions, not its values: torch and JAX generators differ."""
    if cfg.num_experts:
        raise NotImplementedError(
            "mixture-of-experts stacks are not ported yet (ROADMAP "
            "Queue 1 item 7)"
        )
    if cfg.lora_rank:
        raise NotImplementedError(
            "LoRA adapter factors are not ported yet (ROADMAP Queue 1 "
            "item 5, multi-LoRA)"
        )
    device = generator.device if device is None else torch.device(device)
    L, D, F = cfg.num_layers, cfg.dim, cfg.ffn_dim
    dkv = cfg.kv_heads * (D // cfg.num_heads)
    s = D**-0.5

    def draw(shape, scale):
        return normal(generator, shape, scale, dtype, device)

    def const(value, shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    p = {
        "wq": draw((L, D, D), s),
        "wk": draw((L, D, dkv), s),
        "wv": draw((L, D, dkv), s),
        "wo": draw((L, D, D), s),
        "ln1_scale": const(1.0, (L, D)),
        "ln2_scale": const(1.0, (L, D)),
    }
    if cfg.use_bias:
        p.update(
            bq=const(0.0, (L, D)),
            bk=const(0.0, (L, dkv)),
            bv=const(0.0, (L, dkv)),
            bo=const(0.0, (L, D)),
        )
    if cfg.norm_type == "layer":
        p.update(ln1_bias=const(0.0, (L, D)), ln2_bias=const(0.0, (L, D)))
    if cfg.ffn_style == "swiglu":
        p["w3"] = draw((L, D, F), s)
    p["w1"] = draw((L, D, F), s)
    p["w2"] = draw((L, F, D), F**-0.5)
    if cfg.use_bias:
        p["b1"] = const(0.0, (L, F))
        p["b2"] = const(0.0, (L, D))
    return p


def embed_lookup(table: Any, ids: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather. Plain [V, D] tables gather directly;
    int8 weight-only tables ({"q", "s"}, models/quant.py) gather the
    int8 rows and widen only the gathered [B, T, D] slice to f32."""
    quant = isinstance(table, dict) and "q" in table
    rows = table["q"] if quant else table
    emb = rows[ids]
    if quant:
        emb = emb.float() * table["s"]
    return emb


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rms_norm(x, scale, eps):
    """Scale-only RMS normalization (llama), f32 statistics."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def norm_apply(cfg: TransformerConfig, x, p: dict, which: str):
    """The config's normalization ("ln1"/"ln2" param group)."""
    if cfg.norm_type == "rms":
        return _rms_norm(x, p[f"{which}_scale"], cfg.layer_norm_eps)
    return _layer_norm(
        x, p[f"{which}_scale"], p[f"{which}_bias"], cfg.layer_norm_eps
    )


def rope_tables(
    head_dim: int, positions: torch.Tensor, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin, (B or 1, T, 1, Dh/2) f32, for absolute `positions`
    of shape (T,) (shared by the batch) or (B, T) (one row per slot).
    A decoder step computes them once and rotates q and k of every
    layer with them."""
    half = head_dim // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        * 2.0
        / head_dim
    )
    ang = positions.float()[..., None] * freqs  # (..., T, half)
    if ang.ndim == 2:  # shared positions -> add the batch axis
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(
    x_flat: torch.Tensor, head_dim: int, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate-half rotary embedding of a flat (B, T, H*Dh) projection
    with tables from `rope_tables`."""
    b, t, d = x_flat.shape
    x = x_flat.reshape(b, t, d // head_dim, head_dim)
    half = head_dim // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x_flat.dtype).reshape(b, t, d)


def apply_rope(
    x_flat: torch.Tensor,
    head_dim: int,
    positions: torch.Tensor,
    theta: float,
) -> torch.Tensor:
    """Rotary position embedding on a flat (B, T, H*Dh) projection.

    Rotate-half pairing (first half with second half), as HF's llama.
    `positions` are the absolute positions of the T tokens: (T,) shared
    across the batch, or (B, T) per batch element (continuous batching,
    where every slot sits at its own depth)."""
    return rotate(x_flat, head_dim, *rope_tables(head_dim, positions, theta))
