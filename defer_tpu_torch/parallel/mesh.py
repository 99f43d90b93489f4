"""Device discovery for the stage chain (counterpart of
`pipeline_devices` in `defer_tpu/parallel/mesh.py`)."""

from __future__ import annotations

from typing import Sequence

import torch


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process; raises when there is none —
    the port never drops to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "defer_tpu_torch runs on CUDA by default and found no CUDA "
            "device; pass devices=[torch.device('cpu')] to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def pipeline_devices(
    num_stages: int, devices: Sequence[torch.device] | None = None
) -> list[torch.device]:
    """Pick one device per pipeline stage.

    With fewer devices than stages, stages wrap round-robin, so a
    4-stage cut list runs on one card with every stage on cuda:0.
    """
    devs = list(devices) if devices is not None else cuda_devices()
    if not devs:
        raise RuntimeError("no devices given for the pipeline")
    return [devs[i % len(devs)] for i in range(num_stages)]
