"""The port's single-card forward entry point (counterpart of
`__graft_entry__.entry()`): ResNet50 at batch 8, 224x224, bf16 compute.

    fn, args = entry()            # on the card
    probs = fn(*args)             # (8, 1000) softmax rows
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from defer_tpu_torch.models import get_model
from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.pipeline import resolve_device


def entry(
    device: torch.device | str | None = None,
) -> tuple[Callable[..., torch.Tensor], tuple[Any, torch.Tensor]]:
    """Returns (fn, example_args) for a ResNet50 forward: float32 params
    from a generator seeded with 0 and an input of ones, both on
    `device` (default: the first CUDA device; raises without one).
    `fn(params, x)` runs the graph on x cast to bf16."""
    dev = resolve_device(device) if device is not None else cuda_devices()[0]
    model = get_model("resnet50")
    params = model.init(
        torch.Generator(device=dev).manual_seed(0), batch_size=8
    )
    x = torch.ones((8, 224, 224, 3), dtype=torch.float32, device=dev)

    def fn(p, v):
        with torch.inference_mode():
            return model.graph.apply(p, v.to(torch.bfloat16))

    return fn, (params, x)
