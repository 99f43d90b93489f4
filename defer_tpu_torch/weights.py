"""Parameters from the JAX package, as the port's tensors.

`params_from_jax` takes a param tree as `defer_tpu` builds it (a nested
dict of arrays; anything numpy can read, such as jax arrays) and returns
the same tree of torch tensors, so one set of weights drives both
packages. It imports neither jax nor defer_tpu: arrays cross as numpy.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _to_tensor(leaf: Any, device, dtype) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: widen to float32, exactly.
        a = a.astype(np.float32)
    t = torch.tensor(a)  # a copy: never aliases the caller's buffer
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(
    tree: Mapping[str, Any],
    device: torch.device | str = "cpu",
    dtype: torch.dtype | None = None,
) -> dict:
    """Nested dict of arrays -> nested dict of tensors on `device`.
    Floating leaves are cast to `dtype` when it is given; others keep
    their type."""
    return {
        k: params_from_jax(v, device, dtype)
        if isinstance(v, Mapping)
        else _to_tensor(v, device, dtype)
        for k, v in tree.items()
    }
