"""Wire serialization for IR graphs and stage params (counterpart of
`defer_tpu/graph/serialize.py`; the same JSON text for the same graph).

The reference ships each partition to its compute node as Keras
architecture JSON (port 5001, reference src/dispatcher.py:65-70) plus a
framed weights stream (port 5002, src/dispatcher.py:75-88). This is the
same capability for the native IR: a Graph or StageGraph round-trips
through JSON, and params ride the codec's self-describing array frames
— so a stage can be dispatched to a remote host that shares only this
package (or the JAX package: the wire is shared), no model-zoo code or
checkpoint files.

Params keep the JAX package's keys and shapes on the wire: conv kernels
stay HWIO and batch norms unfolded. The O,H,W,I storage and the fold
happen only when a stage places its slice on its device (the registry's
`place` hook, parallel/pipeline.py).

Attrs must be JSON-representable (ints/floats/strings/bools and
nested lists/tuples thereof — the same "hashable, static"
contract the JAX package's OpNode imposes); tuples are canonicalized
back from JSON lists on load.
"""

from __future__ import annotations

import json
from typing import Any

from defer_tpu_torch.graph.ir import Graph, GraphError, OpNode
from defer_tpu_torch.graph.partition import StageGraph

_WIRE_VERSION = 1


def _freeze(v: Any) -> Any:
    """JSON lists -> tuples, recursively (ops index attrs as tuples, as
    the graph builders make them)."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return {k: _freeze(x) for k, x in v.items()}
    return v


def _check_attrs(name: str, attrs: Any) -> None:
    try:
        json.dumps(attrs)
    except (TypeError, ValueError) as e:
        raise GraphError(
            f"node {name!r} has non-JSON-serializable attrs: {e}"
        ) from e


def graph_to_json(g: Graph | StageGraph) -> str:
    """Graph/StageGraph -> JSON string (the architecture wire format)."""
    nodes = [
        {
            "name": n.name,
            "op": n.op,
            "inputs": list(n.inputs),
            "attrs": dict(n.attrs),
        }
        for n in g.nodes
    ]
    for n in nodes:
        _check_attrs(n["name"], n["attrs"])
    doc: dict[str, Any] = {
        "wire_version": _WIRE_VERSION,
        "name": g.name,
        "nodes": nodes,
    }
    if isinstance(g, StageGraph):
        doc["kind"] = "stage"
        doc["input_names"] = list(g.input_names)
        doc["output_names"] = list(g.output_names)
    else:
        doc["kind"] = "graph"
        doc["input_name"] = g.input_name
        doc["output_name"] = g.output_name
    return json.dumps(doc)


def graph_from_json(s: str) -> Graph | StageGraph:
    """Inverse of graph_to_json. Raises GraphError on malformed input."""
    try:
        doc = json.loads(s)
    except json.JSONDecodeError as e:
        raise GraphError(f"not a graph JSON document: {e}") from e
    if not isinstance(doc, dict) or "nodes" not in doc:
        raise GraphError("not a graph JSON document (no 'nodes')")
    ver = doc.get("wire_version")
    if ver != _WIRE_VERSION:
        raise GraphError(
            f"unsupported graph wire version {ver!r} "
            f"(this build speaks {_WIRE_VERSION})"
        )
    try:
        nodes = tuple(
            OpNode(
                name=n["name"],
                op=n["op"],
                inputs=tuple(n["inputs"]),
                attrs=_freeze(n.get("attrs", {})),
            )
            for n in doc["nodes"]
        )
        if doc.get("kind") == "stage":
            return StageGraph(
                name=doc["name"],
                nodes=nodes,
                input_names=tuple(doc["input_names"]),
                output_names=tuple(doc["output_names"]),
            )
        return Graph(
            name=doc["name"],
            nodes=nodes,
            input_name=doc["input_name"],
            output_name=doc["output_name"],
        )
    except (KeyError, TypeError) as e:
        raise GraphError(f"malformed graph JSON: {e!r}") from e


def params_to_frames(params: Any) -> list[tuple[str, Any]]:
    """GraphParams -> ordered (path, tensor) pairs for the weights wire
    ('node/param' paths; deterministic order)."""
    out = []
    for node in sorted(params):
        for pname in sorted(params[node]):
            if "/" in pname:
                # rpartition on the way back would mis-split the path
                # (same guard as runtime/checkpoint.py's _flatten).
                raise GraphError(
                    f"param name {pname!r} under node {node!r} contains "
                    "'/' — not representable on the weights wire"
                )
            out.append((f"{node}/{pname}", params[node][pname]))
    return out


def frames_to_params(pairs: Any) -> dict:
    """Inverse of params_to_frames."""
    params: dict[str, dict] = {}
    for path, arr in pairs:
        node, _, pname = path.rpartition("/")
        if not node:
            raise GraphError(f"malformed param path {path!r}")
        params.setdefault(node, {})[pname] = arr
    return params
