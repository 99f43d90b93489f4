"""Roofline analysis: per-node arithmetic intensity against the card
(counterpart of `defer_tpu/utils/roofline.py`).

MFU says how much of the tensor cores a model uses; it cannot say WHY
the rest is idle. The roofline model does: each op's arithmetic
intensity (FLOPs per HBM byte moved) against the card's ridge point
(peak FLOP/s over peak bytes/s) classifies it compute-bound or
memory-bound. Neither mode below is a simulator; both are triage
signals.

Byte accounting has two modes, and the default differs from the JAX
package's. The unfused mode (`assume_fusion=False`, the default here)
charges every node in isolation: read each input activation once, read
its params once, write its output once. That is what eager PyTorch
executes: it fuses nothing, so each relu, residual add, pad and batch
norm is its own kernel with its own read and write of the activation
(the batch norm is one `addcmul` pass after its fold at placement,
parallel/pipeline.py; its params are counted unfolded, as they travel).
On ResNet50 at batch 128 these passes take more device time than the
convolutions (PERF.md §5: batch norm 3.83 ms and relu/add 3.77 ms
against 3.32 ms of conv, a profile on the card). `assume_fusion=True`
is the JAX package's default, the XLA picture: a fusible elementwise op
receives its first input in registers from its producer and writes its
output only when a non-fusible consumer needs it; its byte counts equal
the JAX package's node for node.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from defer_tpu_torch.graph.ir import Graph, GraphParams
from defer_tpu_torch.utils.flops import (
    flops_by_node,
    lookup_device_table,
    peak_flops,
)

# Peak memory bandwidth by `torch.cuda.get_device_name` substring, bytes
# per second (NVIDIA data sheets). Order matters as in flops._PEAK_BF16:
# "h100 pcie" and "h100 nvl" before "h100".
_PEAK_BW: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 2.0e12),
    ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),  # SXM, e.g. "NVIDIA H100 80GB HBM3"
    ("h200", 4.8e12),
    ("a100", 2.039e12),  # 80GB SXM
    ("l40s", 0.864e12),
)


def peak_bandwidth(device_kind: str) -> float | None:
    """Peak memory bytes/s of a card by name; None if unknown."""
    return lookup_device_table(device_kind, _PEAK_BW)


# Ops XLA fuses into a producer's epilogue (elementwise / data
# movement): under assume_fusion their primary input never round-trips
# memory. Eager PyTorch fuses none of them.
_FUSIBLE = frozenset(
    {
        "relu",
        "relu6",
        "sigmoid",
        "tanh",
        "swish",
        "gelu",
        "softmax",
        "batch_norm",
        "layer_norm",
        "scale",
        "rescale",
        "normalization",
        "identity",
        "dropout",
        "zero_pad",
        "add",
        "multiply",
    }
)


def _nbytes(t: torch.Tensor) -> float:
    return float(math.prod(t.shape)) * t.element_size()


def bytes_by_node(
    graph: Graph,
    params: GraphParams,
    input_shape: Sequence[int],
    input_dtype: Any = None,
    *,
    assume_fusion: bool = False,
    specs: dict | None = None,
) -> dict[str, float]:
    """Per-node memory bytes from the IR's inferred shapes.

    assume_fusion=False (default): each node in isolation (inputs +
    params read, output written), as eager PyTorch runs it.
    assume_fusion=True: fusible elementwise ops receive their FIRST input
    in registers and only write their output if some consumer is
    non-fusible (or it is the graph output). `specs` short-circuits
    shape inference when the caller already ran it."""
    if specs is None:
        specs = graph.infer_shapes(
            params,
            input_shape,
            dtype=torch.float32 if input_dtype is None else input_dtype,
        )
    node_map = graph.node_map
    consumers = graph.consumers()
    out_names = set(getattr(graph, "output_names", ()))
    out_name = getattr(graph, "output_name", None)
    if out_name is not None:
        out_names.add(out_name)

    out: dict[str, float] = {}
    for node in graph.nodes:
        if node.op == "input":
            out[node.name] = 0.0
            continue
        fused = assume_fusion and node.op in _FUSIBLE
        total = 0.0
        # Output write: always for non-fused; for fused only when a
        # non-fusible consumer (or the graph output) materializes it.
        if not fused:
            total += _nbytes(specs[node.name])
        else:
            # A consumer keeps this value in registers only when it is
            # itself fusible AND takes it as its first input.
            needs_write = node.name in out_names or any(
                node_map[c].op not in _FUSIBLE
                or node_map[c].inputs[0] != node.name
                for c in consumers.get(node.name, [])
            )
            if needs_write:
                total += _nbytes(specs[node.name])
        for i, inp in enumerate(node.inputs):
            if fused and i == 0 and node_map[inp].op != "input":
                # Arrives in registers from a computing producer; the
                # graph INPUT has no producer and always streams in.
                continue
            total += _nbytes(specs[inp])
        for arr in params.get(node.name, {}).values():
            total += float(arr.numel()) * arr.element_size()
        out[node.name] = total
    return out


def roofline_report(
    graph: Graph,
    params: GraphParams,
    input_shape: Sequence[int],
    device_kind: str,
    *,
    input_dtype: Any = None,
    top: int = 8,
    assume_fusion: bool = False,
) -> dict:
    """Classify every node against the card's ridge point.

    Returns a dict with totals, the predicted time lower bound per
    node (max of compute time and memory time — the roofline), the
    model-level bound, and the `top` heaviest nodes by predicted time.
    """
    specs = graph.infer_shapes(
        params,
        input_shape,
        dtype=torch.float32 if input_dtype is None else input_dtype,
    )
    flops = flops_by_node(graph, params, input_shape, specs=specs)
    bts = bytes_by_node(
        graph, params, input_shape, assume_fusion=assume_fusion, specs=specs
    )
    pf = peak_flops(device_kind)
    bw = peak_bandwidth(device_kind)
    ridge = (pf / bw) if pf and bw else None

    nodes = []
    for node in graph.nodes:
        if node.op == "input":
            continue
        f, b = flops[node.name], bts[node.name]
        entry = {
            "name": node.name,
            "op": node.op,
            "flops": f,
            "bytes": b,
            "intensity": round(f / b if b else float("inf"), 2),
        }
        if ridge is not None:
            t_compute, t_memory = f / pf, b / bw
            entry["bound"] = "compute" if t_compute >= t_memory else "memory"
            entry["t_lower_s"] = max(t_compute, t_memory)
        nodes.append(entry)

    report: dict = {
        "device_kind": device_kind,
        "peak_flops": pf,
        "peak_bandwidth": bw,
        "assume_fusion": assume_fusion,
        "ridge_intensity": round(ridge, 1) if ridge is not None else None,
        "total_flops": sum(flops.values()),
        "total_bytes": sum(bts.values()),
    }
    if ridge is not None:
        t_total = sum(e["t_lower_s"] for e in nodes)
        by_bound = {"compute": 0.0, "memory": 0.0}
        for e in nodes:
            by_bound[e["bound"]] += e["t_lower_s"]
        report.update(
            {
                "t_lower_s": t_total,
                # Throughput AT this traffic model's bound, not a hard
                # ceiling: a library kernel may move fewer bytes than
                # the model counts (cuDNN re-uses conv inputs on chip).
                "items_per_sec_at_bound": (
                    input_shape[0] / t_total if t_total else None
                ),
                "time_share": {
                    k: round(v / t_total, 3) if t_total else None
                    for k, v in by_bound.items()
                },
                "top_nodes": sorted(
                    nodes, key=lambda e: -e["t_lower_s"]
                )[:top],
            }
        )
    else:
        report["top_nodes"] = sorted(nodes, key=lambda e: -e["flops"])[:top]
    return report


def format_report(report: dict) -> str:
    """Human-readable summary of roofline_report."""
    lines = [
        f"roofline[{report['device_kind']}]: "
        f"{report['total_flops'] / 1e9:.2f} GFLOP, "
        f"{report['total_bytes'] / 1e6:.1f} MB moved"
        + (" (fused)" if report.get("assume_fusion") else " (unfused)")
        + (
            f", ridge {report['ridge_intensity']} FLOP/B"
            if report.get("ridge_intensity")
            else ""
        )
    ]
    if "t_lower_s" in report:
        share = report["time_share"]
        lines.append(
            f"  bound: {share['compute']:.0%} compute / "
            f"{share['memory']:.0%} memory; "
            f"{report['t_lower_s'] * 1e3:.3f} ms a batch, "
            f"{report['items_per_sec_at_bound']:.0f} items/s at the "
            "traffic-model bound"
        )
    for e in report["top_nodes"]:
        t = (
            f" {e['t_lower_s'] * 1e6:.0f}us ({e['bound']})"
            if "t_lower_s" in e
            else ""
        )
        lines.append(
            f"  {e['name']:<28} {e['op']:<16} "
            f"{e['flops'] / 1e6:>9.1f} MFLOP {e['intensity']:>8.1f} F/B{t}"
        )
    return "\n".join(lines)
