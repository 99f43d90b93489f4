"""Op registry for the graph IR.

Every `OpNode.op` string resolves here: an explicit (init, apply) pair
over plain tensors.
"""

from defer_tpu_torch.ops.registry import Op, get_op, op_names, register_op
from defer_tpu_torch.ops import library as _library  # registers the standard ops
from defer_tpu_torch.ops import transformer as _transformer  # transformer ops

__all__ = ["Op", "get_op", "op_names", "register_op"]
