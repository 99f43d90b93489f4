"""Attention: the plain reference and the flash-kernel dispatch
(counterpart of `defer_tpu/ops/attention.py`).

`multi_head_attention` is the single entry point the `mha` op routes
through. Without a bias or a window it takes `flash_attention`, which
launches the hand-written kernel on a CUDA tensor and runs its plain
version on a CPU or meta tensor. With a bias or a window it takes
`attention_reference`, as the JAX package does: neither package has a
kernel for those.
"""

from __future__ import annotations

import torch

from defer_tpu_torch.ops.flash_attention import flash_attention


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) -> (B, H, S, Dh), a strided view of a contiguous x."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """Plain softmax attention on (B, H, S, Dh) tensors, fp32 softmax.

    window=W adds Mistral-style sliding-window masking: query position
    p attends key positions (p-W, p] only (requires causal=True)."""
    if window is not None and not causal:
        raise NotImplementedError("window requires causal attention")
    dh = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        dh**-0.5
    )
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s_q, s_k = logits.shape[-2:]
        qpos = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        kpos = torch.arange(s_k, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    window: int | None = None,
    sp_axis: str | None = None,
    sp_strategy: str = "ring",
) -> torch.Tensor:
    """Attention on (B, S, D) projections; returns (B, S, D).

    window: sliding-window (Mistral-style) masking, causal only; it
    takes the reference path, as in the JAX package.

    sp_axis: mesh axis of sequence parallelism. S is then this rank's
    shard of the sequence and attention runs ring or Ulysses
    (sp_strategy) over that axis (`parallel/sequence.py`), inside a
    distributed mesh's run.
    """
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if sp_axis is not None:
        if bias is not None:
            raise NotImplementedError(
                "bias is not supported under sequence parallelism"
            )
        if window is not None:
            raise NotImplementedError(
                "sliding-window attention is not supported under "
                "sequence parallelism yet"
            )
        from defer_tpu_torch.parallel.sequence import sequence_attention

        return _merge_heads(sequence_attention(
            qh, kh, vh, axis_name=sp_axis, strategy=sp_strategy,
            causal=causal,
        ))
    if bias is None and window is None:
        return _merge_heads(flash_attention(qh, kh, vh, causal=causal))
    return _merge_heads(
        attention_reference(
            qh, kh, vh, bias=bias, causal=causal, window=window
        )
    )
