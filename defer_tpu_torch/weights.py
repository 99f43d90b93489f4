"""Parameters from the JAX package, as the port's tensors.

`params_from_jax` takes a param tree as `defer_tpu` builds it (a nested
dict of arrays; anything numpy can read, such as jax arrays) and returns
the same tree of torch tensors, so one set of weights drives both
packages. The trees of the decoder family cross as they are: adapter
factors and banks (`{target}:a` / `{target}:b`, parallel/lora.py), a
draft's sliced tree (models/transplant.py::make_draft) and int8 leaves
(`{"q", "s"}`) are nested dicts of arrays like any other.
`params_to_numpy` is the way back: the port's tensors as numpy arrays,
which the JAX package takes as they are. Neither imports jax or
defer_tpu: arrays cross as numpy. `tree_to` moves a tree of the port's
tensors to a device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from defer_tpu_torch.parallel.mesh import cuda_devices


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
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> dict:
    """Nested dict of arrays -> nested dict of tensors on `device`.
    Floating leaves are cast to `dtype` when it is given; others keep
    their type. `device` None is the first CUDA device, as the JAX
    package's arrays sit on its default (accelerator) device; it raises
    without a card: pass device="cpu" to load on the CPU."""
    device = device if device is not None else cuda_devices()[0]
    return {
        k: params_from_jax(v, device, dtype)
        if isinstance(v, Mapping)
        else _to_tensor(v, device, dtype)
        for k, v in tree.items()
    }


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host
    (bfloat16 leaves widen to float32, exactly)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_to_numpy(v)
            continue
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[k] = t.numpy()
    return out


def tree_to(tree, device: torch.device):
    """A param tree on `device`; `.to` returns a leaf already there as
    it is, so no copy is made."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
