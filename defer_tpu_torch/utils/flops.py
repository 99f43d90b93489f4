"""Analytic FLOPs of a graph, FLOPs-balanced cuts, and the card's peak
rate for MFU (counterpart of `defer_tpu/utils/flops.py`).

Model FLOPs come from the IR in one node walk over the shapes that
`Graph.infer_shapes` gives on meta tensors; achieved FLOP/s over the
card's peak is the MFU a run reports.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from defer_tpu_torch.graph.ir import Graph, GraphParams

# Dense bf16 tensor-core peak FLOP/s by `torch.cuda.get_device_name`
# substring (NVIDIA data sheets, without sparsity, at the card's full
# power limit). Order matters: "h100 pcie" and "h100 nvl" before "h100".
_PEAK_BF16: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),  # SXM, e.g. "NVIDIA H100 80GB HBM3"
    ("h200", 989e12),
    ("a100", 312e12),
    ("l40s", 362e12),
)


def lookup_device_table(
    device_kind: str, table: tuple[tuple[str, float], ...]
) -> float | None:
    """First (substring, value) match for a device name, case-blind;
    more specific keys come first in a table."""
    kind = device_kind.lower()
    for key, val in table:
        if key in kind:
            return val
    return None


def peak_flops(device_kind: str) -> float | None:
    """Dense bf16 peak FLOP/s of a card by name; None if unknown (the
    CPU: MFU is then not reported)."""
    return lookup_device_table(device_kind, _PEAK_BF16)


# Parameters that act as one side of a contraction: FLOPs = 2 x
# (output spatial/batch positions) x (param elements). Holds for conv
# (kernel HWIO, grouped or not), depthwise (HW1C), separable (dw + pw
# summed), and dense ((in, out)).
_CONTRACTION_PARAMS = ("kernel", "dw_kernel", "pw_kernel")


def node_flops(
    op: str,
    node_params: dict[str, Any],
    out_shape: Sequence[int],
) -> float:
    """Forward FLOPs of one node given its output shape."""
    out_elems = float(math.prod(out_shape)) if out_shape else 1.0
    if op == "dense":
        k = node_params.get("kernel")
        if k is None:
            return out_elems
        return 2.0 * out_elems * k.shape[0]
    if op == "mha" and "wq" in node_params:
        b, s, d = out_shape[-3], out_shape[-2], out_shape[-1]
        return attention_flops(batch=b, seq_len=s, dim=d)
    kernels = [
        node_params[p] for p in _CONTRACTION_PARAMS if p in node_params
    ]
    if kernels and op in ("conv", "depthwise_conv", "separable_conv"):
        out_positions = out_elems / out_shape[-1]
        # kernel [kh, kw, cin/groups, cout]: each output position
        # contracts kh*kw*(cin/groups) per channel.
        return sum(2.0 * out_positions * float(k.numel()) for k in kernels)
    # Everything else (BN folded at inference, activations, pools, adds,
    # softmax) is a small constant per output element.
    return out_elems


def flops_by_node(
    graph: Graph,
    params: GraphParams,
    input_shape: Sequence[int],
    input_dtype: Any = None,
    *,
    specs: Any = None,
) -> dict[str, float]:
    """Per-node forward FLOPs for one input of `input_shape` (batch dim
    included). `specs` skips shape inference when the caller already
    ran it."""
    if specs is None:
        specs = graph.infer_shapes(
            params,
            input_shape,
            dtype=torch.float32 if input_dtype is None else input_dtype,
        )
    return {
        node.name: node_flops(
            node.op, params.get(node.name, {}), tuple(specs[node.name].shape)
        )
        for node in graph.nodes
    }


def graph_flops(
    graph: Graph, params: GraphParams, input_shape: Sequence[int]
) -> float:
    """Total forward FLOPs for one input of `input_shape`."""
    return sum(flops_by_node(graph, params, input_shape).values())


def balanced_cuts(
    graph: Graph,
    params: GraphParams,
    input_shape: Sequence[int],
    num_stages: int,
    candidates: Sequence[Any] | None = None,
    input_dtype: Any = None,
) -> list[Any]:
    """Pick num_stages-1 boundaries that split the graph into stages of
    near-equal FLOPs (not equal candidate count: ResNet50's early
    high-resolution convs are far heavier than its tail). Candidates
    default to chain_boundaries(graph); each is scored by the cumulative
    FLOPs of everything at or before its last member, and the picks
    closest to the i/num_stages fractions win (kept strictly
    increasing)."""
    from defer_tpu_torch.graph.partition import chain_boundaries

    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    if num_stages == 1:
        return []
    if candidates is None:
        candidates = chain_boundaries(graph)
    if num_stages - 1 > len(candidates):
        raise ValueError(
            f"{len(candidates)} candidate boundaries cannot make "
            f"{num_stages} stages"
        )
    per_node = flops_by_node(graph, params, input_shape, input_dtype)
    cum: dict[str, float] = {}
    running = 0.0
    for node in graph.nodes:
        running += per_node[node.name]
        cum[node.name] = running
    total = running

    def score(cand) -> float:
        members = (cand,) if isinstance(cand, str) else cand
        return max(cum[m] for m in members)

    scores = [score(c) for c in candidates]
    picks: list[int] = []
    prev = -1
    remaining = num_stages - 1
    for k in range(1, num_stages):
        target = total * k / num_stages
        # Best candidate for this fraction that still leaves room for
        # the remaining picks and stays after the previous one.
        lo = prev + 1
        hi = len(candidates) - (remaining - len(picks) - 1)
        best = min(range(lo, hi), key=lambda i: abs(scores[i] - target))
        picks.append(best)
        prev = best
    return [candidates[i] for i in picks]


def attention_flops(*, batch: int, seq_len: int, dim: int) -> float:
    """One self-attention layer's forward FLOPs (head-count invariant):
    4 QKVO projection matmuls at 2*B*S*D*D each + the two S x S
    contractions (logits, weighted values) at 2*B*S*S*D each."""
    tokens = float(batch * seq_len)
    return 2.0 * tokens * (4.0 * dim * dim) + 2.0 * tokens * (
        2.0 * seq_len * dim
    )


def transformer_flops(
    *,
    num_layers: int,
    dim: int,
    ffn_dim: int,
    seq_len: int,
    batch: int,
    vocab_size: int = 0,
    num_experts_active: int = 1,
) -> float:
    """Analytic forward FLOPs for one transformer-encoder microbatch:
    per layer 4 QKVO projections + 2 attention matmuls + 2 FFN matmuls."""
    tokens = float(batch * seq_len)
    per_layer = (
        attention_flops(batch=batch, seq_len=seq_len, dim=dim)
        + 2.0 * tokens * (2.0 * dim * ffn_dim) * num_experts_active
    )
    total = num_layers * per_layer
    if vocab_size:
        total += 2.0 * tokens * dim * vocab_size
    return total
