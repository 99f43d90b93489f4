"""Llama-family causal decoder: a configuration of the shared stack.

Counterpart of `defer_tpu/models/llama.py`: RMSNorm, rotary position
embeddings, grouped-query attention and a SwiGLU FFN, all biasless, as
a `TransformerConfig` that `models/gpt.py`'s `GptDecoder` serves; the
GQA cache holds [L, B, Hkv, S, Dh]. `from_hf_state_dict` and
`spmd_llama` are not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from defer_tpu_torch.models.gpt import GptDecoder
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
