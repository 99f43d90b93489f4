"""Device discovery and named meshes (counterpart of
`defer_tpu/parallel/mesh.py`: `describe_topology`, `pipeline_devices`,
`make_mesh`).

A port `Mesh` is the axis names, their sizes and the grid of devices,
with no collectives behind it: in one process a mesh whose only axis
larger than 1 is "stage" runs its stages in turn
(`parallel/spmd_pipeline.py`). A device may repeat in the grid, so
`make_mesh({"stage": 4}, [cuda0] * 4)` is four stages on one card, as
`pipeline_devices` wraps a cut list round-robin. The collectives behind
the other axes wait for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process; raises when there is none —
    the port never drops to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "defer_tpu_torch runs on CUDA by default and found no CUDA "
            "device; pass device='cpu' (or devices=[torch.device('cpu')]) "
            "to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def describe_topology() -> dict:
    """Human/bench-readable snapshot of the CUDA devices of this process."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": "cuda" if n else "cpu",
        "num_devices": n,
        "num_local_devices": n,
        "num_hosts": 1,
        "device_kind": torch.cuda.get_device_name(0) if n else "none",
    }


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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device grid: `devices` is an object array of
    torch.devices shaped by the axis sizes, in `axis_names` order."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0
                      for j in range(len(self.axis_names)))
        return list(self.devices[index])


def make_mesh(
    axes: Mapping[str, int], devices: Sequence[torch.device] | None = None
) -> Mesh:
    """Build a named mesh, e.g. make_mesh({"stage": 4}, [cuda0] * 4).

    Axis order follows dict order; the mesh takes the first
    prod(sizes) devices (every CUDA device when None: raises without a
    card) and raises when it is given fewer."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else cuda_devices())
    shape = tuple(axes.values())
    n = math.prod(shape)
    if n > len(devs):
        raise ValueError(
            f"mesh {dict(axes)} needs {n} devices, have {len(devs)}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(shape), tuple(axes.keys()))
