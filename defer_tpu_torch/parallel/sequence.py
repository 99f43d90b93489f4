"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of `defer_tpu/parallel/sequence.py`).

Both run on already-projected (B, H, S_local, Dh) shards over a "seq"
mesh axis, inside a distributed mesh's run (`parallel/collectives.py`),
and compose with tensor parallelism (heads split over tp first):

  * `ring_attention`: Q stays resident; K and V rotate one hop a step
    with `ppermute` while each rank folds the visiting block into a
    streaming-softmax accumulator (the flash recurrence across ranks,
    with the JAX package's mask value). The S x S score matrix never
    exists. ppermute's backward is the inverse hop, so the gradients of
    K and V travel back around the ring to their rank.
  * `ulysses_attention`: two `all_to_all`s re-shard from positions to
    heads and back, so attention runs unsplit on a head subset (plain
    attention, as in the JAX package); needs H % n == 0.

Neither launches the flash kernel: the JAX package's sequence path is
its plain attention too.
"""

from __future__ import annotations

import torch

from defer_tpu_torch.ops.attention import attention_reference
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.mesh import Mesh

# The JAX package's masked-logit value (pallas_attention._MASK_VALUE):
# finite, so a fully masked block keeps exp() defined.
_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str,
    causal: bool = False,
) -> torch.Tensor:
    """Ring attention on (B, H, S_local, Dh) shards. The global sequence
    is the concatenation of every rank's shard in axis-index order;
    returns this rank's shard of the output."""
    n = collectives.axis_size(axis_name)
    idx = collectives.axis_index(axis_name)
    # K/V travel backward around the ring (rank i receives from i+1), so
    # after t steps rank i holds the block of rank (i + t) % n.
    perm = [(i, (i - 1) % n) for i in range(n)]
    s_local = q.shape[2]
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    m = torch.full(q.shape[:3], _MASK_VALUE, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros_like(qf)
    pos = torch.arange(s_local, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (idx + t) % n  # the rank k_cur / v_cur came from
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * scale
        if causal:
            keep = (idx * s_local + pos)[:, None] >= (src * s_local + pos)
            s = torch.where(keep, s, _MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if t < n - 1:  # the last block needs no further hop
            k_cur = collectives.ppermute(k_cur, axis_name, perm)
            v_cur = collectives.ppermute(v_cur, axis_name, perm)
    return (acc / l[..., None]).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str,
    causal: bool = False,
) -> torch.Tensor:
    """Ulysses attention on (B, H, S_local, Dh) shards: all_to_all to
    (B, H/n, S, Dh), plain attention on the whole sequence for the local
    head group, all_to_all back."""
    n = collectives.axis_size(axis_name)
    if q.shape[1] % n:
        raise ValueError(
            f"num local heads {q.shape[1]} must divide by seq axis size {n}"
        )

    def to_heads(x):
        return collectives.all_to_all(x, axis_name, split_axis=1,
                                      concat_axis=2)

    out = attention_reference(to_heads(q), to_heads(k), to_heads(v),
                              causal=causal)
    return collectives.all_to_all(out, axis_name, split_axis=2,
                                  concat_axis=1)


def sequence_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str | None,
    strategy: str = "ring",
    causal: bool = False,
) -> torch.Tensor:
    """Dispatch on (B, H, S_local, Dh): ring / ulysses / local."""
    if axis_name is None:
        return attention_reference(q, k, v, causal=causal)
    if strategy == "ring":
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal)
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, axis_name=axis_name, causal=causal)
    raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")


def make_sharded_attention(
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
    strategy: str = "ring",
    causal: bool = False,
):
    """(q, k, v) -> out on global (B, H, S, Dh) tensors, the same on
    every rank, with S split over `seq_axis`: the standalone entry point
    (the transformer stack calls `sequence_attention` inside its own
    pipeline run instead). The output comes back whole on every rank."""

    def attn(q, k, v):
        with collectives.active(mesh):
            shards = [collectives.shard(t, seq_axis, 2) for t in (q, k, v)]
            out = sequence_attention(*shards, axis_name=seq_axis,
                                     strategy=strategy, causal=causal)
            return collectives.unshard(out, seq_axis, 2)

    return attn
