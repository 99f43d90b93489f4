"""BERT-base encoder, IR form (counterpart of `bert_base`/`bert_tiny` in
`defer_tpu/models/bert.py`): token-id input, embeddings, encoder
blocks, CLS pooler. Cut candidates are the block outputs
(`encoder_{i}_out`), so the pipeline cuts it at block boundaries.
"""

from __future__ import annotations

import torch

from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import Model, register_model


def _build_bert(
    name: str,
    *,
    num_layers: int,
    dim: int,
    num_heads: int,
    ffn_dim: int,
    vocab_size: int,
    max_len: int,
    seq_len: int,
) -> Model:
    b = GraphBuilder(name)
    ids = b.input("input_ids")
    x = b.add(
        "embedding",
        ids,
        name="token_embedding",
        vocab_size=vocab_size,
        features=dim,
    )
    x = b.add("pos_embedding", x, name="position_embedding", max_len=max_len)
    x = b.add("layer_norm", x, name="embeddings_ln")
    cuts: list[str] = []
    for i in range(num_layers):
        attn = b.add("mha", x, name=f"encoder_{i}_mha", num_heads=num_heads)
        x = b.add("add", x, attn, name=f"encoder_{i}_attn_add")
        x = b.add("layer_norm", x, name=f"encoder_{i}_attn_ln")
        h = b.add("dense", x, name=f"encoder_{i}_ffn_in", features=ffn_dim)
        h = b.add("gelu", h, name=f"encoder_{i}_ffn_gelu")
        h = b.add("dense", h, name=f"encoder_{i}_ffn_out", features=dim)
        x = b.add("add", x, h, name=f"encoder_{i}_ffn_add")
        x = b.add("layer_norm", x, name=f"encoder_{i}_out")
        cuts.append(x)
    cls = b.add("take_token", x, name="cls_token", index=0)
    pooled = b.add("dense", cls, name="pooler_dense", features=dim)
    pooled = b.add("tanh", pooled, name="pooler")
    return Model(
        name=name,
        graph=b.build(pooled),
        input_shape=(seq_len,),
        input_dtype=torch.int64,
        cut_candidates=tuple(cuts[:-1]),  # last block output == graph tail
    )


@register_model("bert_base")
def bert_base(seq_len: int = 128) -> Model:
    return _build_bert(
        "bert_base",
        num_layers=12,
        dim=768,
        num_heads=12,
        ffn_dim=3072,
        vocab_size=30522,
        max_len=512,
        seq_len=seq_len,
    )


@register_model("bert_tiny")
def bert_tiny(seq_len: int = 16) -> Model:
    """Small config for tests."""
    return _build_bert(
        "bert_tiny",
        num_layers=4,
        dim=32,
        num_heads=4,
        ffn_dim=64,
        vocab_size=128,
        max_len=64,
        seq_len=seq_len,
    )
