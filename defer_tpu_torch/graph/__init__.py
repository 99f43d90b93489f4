from defer_tpu_torch.graph.ir import Graph, GraphBuilder, OpNode
from defer_tpu_torch.graph.partition import (
    PartitionError,
    partition,
    stage_params,
    validate_cut_points,
)

__all__ = [
    "Graph",
    "GraphBuilder",
    "OpNode",
    "PartitionError",
    "partition",
    "stage_params",
    "validate_cut_points",
]
