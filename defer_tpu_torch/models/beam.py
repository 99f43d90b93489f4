"""Beam-search decoding on the KV-cache decoder.

Counterpart of `defer_tpu/models/beam.py`. Beams are the batch: one
(beam, 1) step a token, through `flash_decode` on a CUDA decoder with a
flat cache; a beam reorder is an `index_select` along the cache's batch
axis. Scores are summed log-probs with an optional length penalty.
"""

from __future__ import annotations

from typing import Any

import torch


def beam_search(
    dec: Any,
    params: dict,
    prompt_ids: torch.Tensor,
    num_steps: int,
    *,
    beam_size: int = 4,
    length_penalty: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search continuation of `prompt_ids` [1, T0] on the
    decoder's device.

    Returns (ids [beam, T0 + num_steps], scores [beam] f32) sorted best
    first; scores are sum log-prob / (num_steps ** length_penalty).
    beam_size=1 is greedy `generate`. Decoding is fixed-length (no
    eos), so length_penalty rescales scores without reordering beams."""
    if prompt_ids.shape[0] != 1:
        raise ValueError("beam_search takes one prompt ([1, T0])")
    if beam_size < 1:
        raise ValueError(f"beam_size={beam_size} must be >= 1")
    t0 = prompt_ids.shape[1]
    if not getattr(dec, "rolling_cache", False) and (
        t0 + num_steps > dec.cfg.max_len
    ):
        raise ValueError(
            f"prompt {t0} + steps {num_steps} exceeds max_len "
            f"{dec.cfg.max_len}"
        )
    B = beam_size
    prompt_ids = prompt_ids.to(dec.device)
    step = dec.make_step()
    # Prefill once at batch 1, then repeat the lane: the beams' prompt
    # states are identical.
    last, small = dec.prefill(params, dec.init_cache(1), prompt_ids)
    cache = {
        "k": small["k"].repeat_interleave(B, dim=1),
        "v": small["v"].repeat_interleave(B, dim=1),
        "pos": small["pos"],
    }
    del small
    ids = prompt_ids.repeat(B, 1)
    logp = torch.log_softmax(last.float(), dim=-1)  # (1, V)
    # All beams start identical: only beam 0 may seed candidates.
    scores = torch.where(
        torch.arange(B, device=dec.device) == 0, 0.0, -torch.inf
    )
    vocab = logp.shape[-1]
    for i in range(num_steps):
        total = scores[:, None] + logp  # (B, V) by broadcast
        scores, flat = torch.topk(total.reshape(-1), B)
        beam_idx = flat // vocab
        token = (flat % vocab).to(ids.dtype)
        ids = torch.cat([ids[beam_idx], token[:, None]], dim=1)
        if i + 1 == num_steps:
            break  # the final tokens' successor logits are never used
        cache = {
            "k": cache["k"].index_select(1, beam_idx),
            "v": cache["v"].index_select(1, beam_idx),
            "pos": cache["pos"],
        }
        logits, cache = step(params, cache, token[:, None])
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    if length_penalty:
        scores = scores / (num_steps**length_penalty)
    order = torch.argsort(-scores)
    return ids[order], scores[order]
