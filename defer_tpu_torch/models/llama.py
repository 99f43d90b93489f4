"""Llama-family causal decoder: a configuration of the shared stack.

Counterpart of `defer_tpu/models/llama.py`: RMSNorm, rotary position
embeddings, grouped-query attention and a SwiGLU FFN, all biasless, as
a `TransformerConfig` that `models/gpt.py`'s `GptDecoder` serves; the
GQA cache holds [L, B, Hkv, S, Dh]. `from_hf_state_dict` maps a
HuggingFace Llama state dict onto the decoder's params; `spmd_llama`
serves it tensor-parallel on `SpmdGptDecoder`.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from defer_tpu_torch.models.gpt import GptDecoder, SpmdGptDecoder
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig


def llama_config(
    *,
    num_layers: int = 32,
    dim: int = 4096,
    num_heads: int = 32,
    num_kv_heads: int = 8,
    ffn_dim: int = 14336,
    vocab_size: int = 32000,
    max_len: int = 4096,
    rope_theta: float = 10000.0,
    eps: float = 1e-5,
    window: int | None = None,
) -> TransformerConfig:
    """The llama architecture as a TransformerConfig (defaults are
    7B-class shapes; tests use tiny ones)."""
    return TransformerConfig(
        num_layers=num_layers,
        dim=dim,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        ffn_dim=ffn_dim,
        vocab_size=vocab_size,
        max_len=max_len,
        layer_norm_eps=eps,
        norm_style="pre",
        norm_type="rms",
        ffn_style="swiglu",
        pos_style="rope",
        use_bias=False,
        rope_theta=rope_theta,
        causal=True,
        window=window,
    )


def mistral_config(**kw) -> TransformerConfig:
    """Mistral = the llama architecture + sliding-window attention (each
    position attends its last `window` predecessors; default 4096, as
    Mistral-7B-v0.1's published config)."""
    kw.setdefault("window", 4096)
    return llama_config(**kw)


def tiny_llama(seq_len: int = 32, *, device=None) -> GptDecoder:
    """Small llama-shaped decoder for tests / CPU."""
    return GptDecoder(
        llama_config(
            num_layers=2,
            dim=64,
            num_heads=4,
            num_kv_heads=2,
            ffn_dim=128,
            vocab_size=96,
            max_len=seq_len,
        ),
        compute_dtype=torch.float32,
        device=device,
    )


def spmd_llama(
    mesh: Any,
    cfg: TransformerConfig,
    *,
    compute_dtype: Any = torch.bfloat16,
    tp_axis: str = "model",
    dp_axis: str | None = None,
) -> SpmdGptDecoder:
    """Tensor-parallel llama serving: head-group-split projections and
    GQA caches, vocab-split tied head (SpmdGptDecoder), which needs
    num_kv_heads % tp == 0."""
    return SpmdGptDecoder(
        cfg,
        compute_dtype=compute_dtype,
        mesh=mesh,
        tp_axis=tp_axis,
        dp_axis=dp_axis,
    )


def from_hf_state_dict(
    cfg: TransformerConfig,
    state_dict: Mapping[str, Any],
    device: torch.device | str | None = None,
) -> dict:
    """Map a HuggingFace `LlamaForCausalLM.state_dict()` onto the
    decoder's params, on `device`, each leaf in the checkpoint's dtype.
    `device` None is the first CUDA device, as the JAX package puts the
    arrays on its default (accelerator) device; it raises without a
    card: pass device="cpu" to load on the CPU.

    Torch Linear stores [out, in]; the stack computes x @ W with
    [in, out], so every projection transposes. w1 = gate (the silu
    branch), w3 = up, w2 = down: the stack's swiglu convention. The head
    is tied to `token_embedding` unless the checkpoint ships an
    `lm_head.weight` that differs from it (untied releases); a tied
    checkpoint that lists the aliased head keeps the tied tree."""
    device = device if device is not None else cuda_devices()[0]
    L = cfg.num_layers

    def t(name: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).detach().to(device)

    def stacked(fmt: str, transpose: bool = True) -> torch.Tensor:
        mats = [t(fmt.format(i)) for i in range(L)]
        return torch.stack([m.T if transpose else m for m in mats])

    attn = "model.layers.{}.self_attn.%s.weight"
    mlp = "model.layers.{}.mlp.%s.weight"
    stack = {
        "wq": stacked(attn % "q_proj"),
        "wk": stacked(attn % "k_proj"),
        "wv": stacked(attn % "v_proj"),
        "wo": stacked(attn % "o_proj"),
        "w1": stacked(mlp % "gate_proj"),
        "w3": stacked(mlp % "up_proj"),
        "w2": stacked(mlp % "down_proj"),
        "ln1_scale": stacked("model.layers.{}.input_layernorm.weight",
                             False),
        "ln2_scale": stacked(
            "model.layers.{}.post_attention_layernorm.weight", False
        ),
    }
    kv_dim = cfg.kv_heads * (cfg.dim // cfg.num_heads)
    if tuple(stack["wk"].shape) != (L, cfg.dim, kv_dim):
        raise ValueError(
            f"k_proj stacks to {tuple(stack['wk'].shape)}, the config "
            f"wants {(L, cfg.dim, kv_dim)}"
        )
    params = {
        "token_embedding": t("model.embed_tokens.weight"),
        "final_ln_scale": t("model.norm.weight"),
        "stack": {k: v.contiguous() for k, v in stack.items()},
    }
    if "lm_head.weight" in state_dict:
        head = t("lm_head.weight")
        if not torch.equal(head, params["token_embedding"]):
            params["lm_head"] = head
    return params
