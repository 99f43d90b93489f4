"""Cut-point partitioner: Graph -> chain of stage Graphs (counterpart of
`defer_tpu/graph/partition.py`; pure Python, the same checks and the
same PartitionError messages).

`validate_cut_points` proves each cut is a valid chain boundary: every
edge crossing it originates at the cut itself, so a cut inside a
residual branch is refused instead of silently miscompiling. Stages are
induced subgraphs; each op appears in exactly one stage, once. A graph
cut at [c1, ..., cN] yields N+1 stages.

**Multi-tensor boundaries**: a cut may be a *tuple* of node names,
meaning the pipeline relays that bundle of tensors across the boundary
together (NASNet-class graphs, whose cells consume both their
predecessor and pre-predecessor, need this).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

from defer_tpu_torch.graph.ir import (
    INPUT_OP,
    Graph,
    GraphParams,
    OpNode,
    execute_nodes,
)

# One boundary: a single articulation node, or a bundle of nodes whose
# outputs jointly separate the chain.
CutSpec = Union[str, Sequence[str]]


class PartitionError(ValueError):
    pass


def _as_bundle(cut: CutSpec) -> tuple[str, ...]:
    return (cut,) if isinstance(cut, str) else tuple(cut)


@dataclasses.dataclass(frozen=True)
class StageGraph:
    """A pipeline stage with a multi-tensor entry and/or exit.

    Same execution contract as Graph.apply, but `apply` takes/returns a
    tuple when the boundary carries more than one tensor. Single-tensor
    boundaries keep plain tensors, so downstream code (device transfer,
    sync) treats both uniformly as nested tuples.
    """

    name: str
    nodes: tuple[OpNode, ...]
    input_names: tuple[str, ...]
    output_names: tuple[str, ...]

    def apply(self, params: GraphParams, x):
        xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        if len(xs) != len(self.input_names):
            raise PartitionError(
                f"stage {self.name!r} expects {len(self.input_names)} input "
                f"tensors {self.input_names}, got {len(xs)}"
            )
        out = execute_nodes(
            self.nodes, params, dict(zip(self.input_names, xs)),
            self.output_names,
        )
        outs = tuple(out[o] for o in self.output_names)
        return outs if len(outs) > 1 else outs[0]


def _bundle_ancestors(graph: Graph, bundle: tuple[str, ...]) -> set[str]:
    anc: set[str] = set()
    for c in bundle:
        anc |= graph.ancestors(c)
    return anc


def validate_cut_points(
    graph: Graph, cuts: Sequence[CutSpec]
) -> list[set[str]]:
    """Raise PartitionError unless every cut is a valid chain boundary;
    returns each boundary's ancestor set (reused by partition() so the
    O(V+E) sweeps aren't repeated).

    A boundary B (one node, or a bundle) is valid iff every edge
    (u -> v) with u on B's ancestor side and v on the other side
    originates at a member of B; then exactly the bundle's outputs cross
    the boundary, which is what the pipeline relays to the next stage
    (the analogue of the single activation the reference ships per hop,
    reference src/node.py:125-133).
    """
    node_map = graph.node_map
    ancestor_sets: list[set[str]] = []
    prev_ancestors: set[str] = set()
    prev_bundle: set[str] = set()
    for cut in cuts:
        bundle = _as_bundle(cut)
        if not bundle:
            raise PartitionError("empty cut bundle")
        for c in bundle:
            if c not in node_map:
                raise PartitionError(
                    f"cut point {c!r} is not a node of graph {graph.name!r}"
                )
            if c in (graph.input_name, graph.output_name):
                raise PartitionError(
                    f"cut point {c!r} cannot be the graph input/output"
                )
        if len(set(bundle)) != len(bundle):
            raise PartitionError(f"duplicate node in cut bundle {bundle!r}")
        anc = _bundle_ancestors(graph, bundle)
        if not prev_ancestors <= anc:
            raise PartitionError(
                f"cut points must be in topological chain order; {bundle!r} "
                "does not dominate the previous cut"
            )
        if prev_ancestors >= anc:
            raise PartitionError(
                f"cut {bundle!r} adds no nodes beyond the previous "
                "boundary — stages must be non-empty"
            )
        for c in bundle:
            # A member computed before the previous boundary is only
            # available here if the previous boundary relayed it.
            if c in prev_ancestors and c not in prev_bundle:
                raise PartitionError(
                    f"bundle member {c!r} is computed before the previous "
                    f"boundary but not carried across it; add {c!r} to the "
                    "previous bundle so its activation is relayed through"
                )
        bundle_set = set(bundle)
        for node in graph.nodes:
            if node.name in anc:
                continue
            for inp in node.inputs:
                if inp in anc and inp not in bundle_set:
                    raise PartitionError(
                        f"invalid cut at {bundle!r}: edge {inp!r} -> "
                        f"{node.name!r} crosses the boundary, so the cut "
                        "does not separate the chain (e.g. a cut inside a "
                        f"residual branch). Add {inp!r} to the bundle or "
                        "move the cut."
                    )
        ancestor_sets.append(anc)
        prev_ancestors = anc
        prev_bundle = set(bundle)
    return ancestor_sets


def articulation_points(graph: Graph) -> list[str]:
    """All valid single-tensor cut points, in topological order.

    The discovery the reference leaves to the user: its README-era cut
    lists were found by hand (reference src/test.py:24-28 documents
    them in a comment). A node c qualifies iff every edge leaving c's
    ancestor set originates at c itself.

    Candidates are restricted to ancestors of the output: a cut at a
    node the output doesn't depend on would satisfy the raw edge
    condition in degenerate graphs (a dead sink that consumes
    everything) but partition() cannot build a stage chain from it, so
    such nodes are excluded by design.

    This is exactly the width-1 case of chain_boundaries' frontier
    sweep: a node is an articulation point iff, right after it is
    processed, it is the sole producer with open out-edges.
    """
    return [
        c for c in chain_boundaries(graph, max_width=1)
        if isinstance(c, str)
    ]


def chain_boundaries(
    graph: Graph, max_width: int = 2
) -> list[CutSpec]:
    """All valid chain boundaries up to `max_width` tensors, topo order.

    Generalizes articulation_points to multi-tensor bundles: at each
    topological position the *frontier* — live producers with an edge
    still open to a later (or dead) consumer — is exactly the value
    set a boundary there must relay. Width 1 is a single-tensor cut
    (returned as a plain name); width 2..max_width is a bundle tuple.
    This is the discovery that makes NASNet-class graphs pipelinable
    without hand-written cut lists: no single tensor separates the
    cell chain, but the (cell_i, cell_i-1) frontier does.

    Edges into dead nodes (non-ancestors of the output) are never
    closed, keeping discovery consistent with validate_cut_points:
    a producer feeding a dead consumer must ride every later boundary.
    """
    if max_width < 1:
        raise PartitionError("max_width must be >= 1")
    live = graph.ancestors(graph.output_name)
    consumers = graph.consumers()
    topo_index = {node.name: i for i, node in enumerate(graph.nodes)}
    open_edges: dict[str, int] = {}
    frontier: set[str] = set()
    out: list[CutSpec] = []
    for node in graph.nodes:
        if node.name not in live:
            continue  # dead consumers never close their in-edges
        for inp in node.inputs:
            open_edges[inp] -= 1
            if open_edges[inp] == 0:
                frontier.discard(inp)
        deg = len(consumers[node.name])
        if deg:
            open_edges[node.name] = deg
            frontier.add(node.name)
        if node.name == graph.output_name:
            continue
        if (
            1 <= len(frontier) <= max_width
            and graph.input_name not in frontier
        ):
            members = sorted(frontier, key=topo_index.__getitem__)
            out.append(members[0] if len(members) == 1 else tuple(members))
    return out


def partition(
    graph: Graph, cuts: Sequence[CutSpec]
) -> list[Graph | StageGraph]:
    """Split `graph` at `cuts` into a chain of stages.

    Stage i's input placeholders keep the *cut nodes' names* (op
    rewritten to "input"), so parameters keep their global node-name
    keys and `stage_params` is a plain dict slice. Single-tensor
    boundaries yield plain Graph stages; bundle boundaries yield
    StageGraph stages whose apply exchanges tuples.
    """
    bundles = [_as_bundle(c) for c in cuts]
    ancestor_sets = validate_cut_points(graph, bundles)

    entries = [(graph.input_name,), *bundles]
    exits = [*bundles, (graph.output_name,)]
    segment_of: dict[str, int] = {}
    prev_anc: set[str] = set()
    for i, anc in enumerate(ancestor_sets):
        for name in anc - prev_anc:
            segment_of[name] = i
        prev_anc = anc
    for node in graph.nodes:
        if node.name not in segment_of:
            segment_of[node.name] = len(bundles)

    stages: list[Graph | StageGraph] = []
    for i in range(len(bundles) + 1):
        entry = entries[i]
        entry_set = set(entry)
        nodes: list[OpNode] = [OpNode(e, INPUT_OP, ()) for e in entry]
        for node in graph.nodes:
            # Cut nodes belong to the producing segment (each is its own
            # ancestor); the consuming stage sees them only as the
            # placeholders created above.
            if segment_of[node.name] != i or node.name in entry_set:
                continue
            nodes.append(node)
        if len(entry) == 1 and len(exits[i]) == 1:
            stages.append(
                Graph(
                    name=f"{graph.name}.stage{i}",
                    nodes=tuple(nodes),
                    input_name=entry[0],
                    output_name=exits[i][0],
                )
            )
        else:
            stages.append(
                StageGraph(
                    name=f"{graph.name}.stage{i}",
                    nodes=tuple(nodes),
                    input_names=entry,
                    output_names=exits[i],
                )
            )
    return stages


def stage_params(params: GraphParams, stage: Graph | StageGraph) -> dict:
    """Slice the full parameter tree down to one stage's nodes.

    Entry placeholders are excluded: a cut node's parameters live in
    the stage that *computes* it — the consuming stage only receives
    its activation, so shipping the weights there too would waste
    device memory.
    """
    names = {n.name for n in stage.nodes if n.op != INPUT_OP}
    return {k: v for k, v in params.items() if k in names and v}
