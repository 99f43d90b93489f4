"""Framework-neutral DAG IR for models (counterpart of
`defer_tpu/graph/ir.py`).

A model is an explicit DAG of named ops; execution walks the
topological order once with a value cache, so multi-branch models cost
each op exactly once, and partitioning is ordinary graph surgery.

Shapes and dtypes are inferred from the op `apply` functions by running
them on meta tensors (no data, no device work) — the role
`jax.eval_shape` plays in the JAX package — so there is one source of
shape truth.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

# Params for one node: dict of named tensors (possibly empty).
NodeParams = Mapping[str, torch.Tensor]
# Params for a graph: node name -> NodeParams. A plain nested dict, so
# it slices cleanly per stage.
GraphParams = Mapping[str, NodeParams]

INPUT_OP = "input"


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One named op in the DAG.

    Attributes:
      name: unique node name (cut points are specified by these names).
      op: op kind, resolved against the op registry (defer_tpu_torch.ops).
      inputs: names of producer nodes, in argument order.
      attrs: static attributes (strides, padding, ...).
    """

    name: str
    op: str
    inputs: tuple[str, ...]
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class GraphError(ValueError):
    pass


def _on_meta(params: NodeParams) -> dict[str, torch.Tensor]:
    return {k: v.to("meta") for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class Graph:
    """A single-input single-output DAG of ops in topological order."""

    name: str
    nodes: tuple[OpNode, ...]
    input_name: str
    output_name: str

    def __post_init__(self) -> None:
        seen: set[str] = set()
        for node in self.nodes:
            if node.name in seen:
                raise GraphError(f"duplicate node name {node.name!r}")
            for inp in node.inputs:
                if inp not in seen:
                    raise GraphError(
                        f"node {node.name!r} consumes {inp!r} before it is "
                        "defined — nodes must be topologically ordered"
                    )
            seen.add(node.name)
        if self.input_name not in seen:
            raise GraphError(f"input node {self.input_name!r} not in graph")
        if self.output_name not in seen:
            raise GraphError(f"output node {self.output_name!r} not in graph")

    # -- lookups ---------------------------------------------------------

    @property
    def node_map(self) -> dict[str, OpNode]:
        return {n.name: n for n in self.nodes}

    def __contains__(self, name: str) -> bool:
        return any(n.name == name for n in self.nodes)

    def consumers(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {n.name: [] for n in self.nodes}
        for n in self.nodes:
            for inp in n.inputs:
                out[inp].append(n.name)
        return out

    def ancestors(self, name: str) -> set[str]:
        """All nodes from which `name` is reachable, inclusive."""
        node_map = self.node_map
        if name not in node_map:
            raise GraphError(f"no node named {name!r} in graph {self.name!r}")
        result: set[str] = set()
        stack = [name]
        while stack:
            cur = stack.pop()
            if cur in result:
                continue
            result.add(cur)
            stack.extend(node_map[cur].inputs)
        return result

    # -- init / apply ----------------------------------------------------

    def init(
        self,
        generator: torch.Generator,
        input_shape: Sequence[int],
        *,
        param_dtype: Any = torch.float32,
        input_dtype: Any = torch.float32,
    ) -> GraphParams:
        """Initialize parameters for every node, drawn in node order from
        `generator`, on the generator's device.

        Output shapes are derived from each op's `apply` on meta tensors
        so there is exactly one source of shape truth.
        """
        from defer_tpu_torch.ops import get_op

        specs: dict[str, torch.Tensor] = {}
        params: dict[str, dict[str, torch.Tensor]] = {}
        for node in self.nodes:
            if node.op == INPUT_OP:
                specs[node.name] = torch.empty(
                    tuple(input_shape), dtype=input_dtype, device="meta"
                )
                params[node.name] = {}
                continue
            op = get_op(node.op)
            in_specs = [specs[i] for i in node.inputs]
            node_params = op.init(
                generator,
                node.attrs,
                [tuple(s.shape) for s in in_specs],
                param_dtype,
            )
            params[node.name] = node_params
            specs[node.name] = op.apply(
                _on_meta(node_params), in_specs, node.attrs
            )
        return params

    def infer_shapes(
        self,
        params: GraphParams,
        input_shape: Sequence[int],
        dtype: Any = torch.float32,
    ) -> dict[str, torch.Tensor]:
        """Every node's output for a given input spec, as a meta tensor
        (shape and dtype, no data)."""
        x = torch.empty(tuple(input_shape), dtype=dtype, device="meta")
        meta = {n: _on_meta(p) for n, p in params.items()}
        return execute_nodes(
            self.nodes,
            meta,
            {self.input_name: x},
            tuple(n.name for n in self.nodes),
        )

    def apply(self, params: GraphParams, x: torch.Tensor) -> torch.Tensor:
        """Run the graph: a single topological pass with a value cache."""
        return execute_nodes(
            self.nodes, params, {self.input_name: x}, (self.output_name,)
        )[self.output_name]


def execute_nodes(
    nodes: Sequence[OpNode],
    params: GraphParams,
    seeded: Mapping[str, torch.Tensor],
    outputs: Sequence[str],
) -> dict[str, torch.Tensor]:
    """Topological walk shared by Graph.apply and multi-tensor stages
    (graph/partition.py): run `nodes` with `seeded` values standing in
    for input placeholders, return the named `outputs`.

    Dead intermediates are evicted eagerly, so their memory is freed as
    soon as their last consumer ran.
    """
    from defer_tpu_torch.ops import get_op

    cache: dict[str, torch.Tensor] = dict(seeded)
    consumers_left: dict[str, int] = {n.name: 0 for n in nodes}
    for n in nodes:
        for i in n.inputs:
            consumers_left[i] += 1
    for o in outputs:
        consumers_left[o] += 1  # never evict requested outputs
    for node in nodes:
        if node.op == INPUT_OP:
            if node.name not in cache:
                raise GraphError(
                    f"no value seeded for input placeholder {node.name!r}"
                )
            continue
        op = get_op(node.op)
        inputs = [cache[i] for i in node.inputs]
        cache[node.name] = op.apply(
            params.get(node.name, {}), inputs, node.attrs
        )
        for i in node.inputs:
            consumers_left[i] -= 1
            if consumers_left[i] == 0:
                del cache[i]
    return {o: cache[o] for o in outputs}


class GraphBuilder:
    """Imperative builder producing an immutable `Graph`.

    Auto-names nodes per op kind (dense, dense_1, dense_2, ...) unless an
    explicit name is given, mirroring Keras naming so cut lists carry
    over unchanged.
    """

    def __init__(self, name: str):
        self.name = name
        self._nodes: list[OpNode] = []
        self._names: set[str] = set()
        self._counters: dict[str, int] = {}
        self._input_name: str | None = None

    def _fresh(self, op: str) -> str:
        n = self._counters.get(op, 0)
        self._counters[op] = n + 1
        return op if n == 0 else f"{op}_{n}"

    def input(self, name: str = "input") -> str:
        if self._input_name is not None:
            raise GraphError("graph already has an input node")
        self._input_name = name
        return self.add(INPUT_OP, name=name)

    def add(
        self,
        op: str,
        *inputs: str,
        name: str | None = None,
        **attrs: Any,
    ) -> str:
        if name is None:
            name = self._fresh(op)
        if name in self._names:
            raise GraphError(f"duplicate node name {name!r}")
        for inp in inputs:
            if inp not in self._names:
                raise GraphError(
                    f"node {name!r}: unknown input {inp!r} (must be added "
                    "before use)"
                )
        self._names.add(name)
        self._nodes.append(OpNode(name, op, tuple(inputs), dict(attrs)))
        return name

    def build(self, output: str) -> Graph:
        if self._input_name is None:
            raise GraphError("graph has no input node")
        return Graph(
            name=self.name,
            nodes=tuple(self._nodes),
            input_name=self._input_name,
            output_name=output,
        )
