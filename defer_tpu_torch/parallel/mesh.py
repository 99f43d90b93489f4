"""Device discovery and named meshes (counterpart of
`defer_tpu/parallel/mesh.py`: `describe_topology`, `pipeline_devices`,
`make_mesh`).

A port `Mesh` is the axis names, their sizes and the grid of devices,
in one of two forms:

  * in one process (no process group, or one whose size is not the
    mesh's): every position is this process, and only the "stage" axis
    may be larger than 1; the stages run in turn
    (`parallel/spmd_pipeline.py`). A device may repeat in the grid, so
    `make_mesh({"stage": 4}, [cuda0] * 4)` is four stages on one card,
    as `pipeline_devices` wraps a cut list round-robin;
  * over the ranks of an initialised process group
    (`parallel/multihost.py` `initialize`) whose size is the mesh's: one
    process per position, rank r at position `np.unravel_index(r,
    shape)` (the JAX package's device order) on its own device, with
    one process group per line of every axis (`group`), which the
    collectives (`parallel/collectives.py`) run over, and one over every
    rank of the mesh (`everyone`), its own on each mesh: two meshes over
    the same ranks never share a group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist


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
    torch.devices shaped by the axis sizes, in `axis_names` order.

    Over a process group, `ranks` is the grid of ranks beside it, `rank`
    this process's, `groups` this rank's process group along each axis
    and `everyone` the group of all the mesh's ranks; all four are None
    in one process. A stage's submesh that this rank is not in
    (`parallel/multihost.py` `stage_submeshes`) carries its ranks but
    no rank and no groups."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None
    rank: int | None = None
    groups: dict | None = None
    everyone: object = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along every axis (0s in one process)."""
        if not self.distributed:
            return {a: 0 for a in self.axis_names}
        where = np.argwhere(self.ranks == self.rank)[0]
        return {a: int(i) for a, i in zip(self.axis_names, where)}

    @property
    def local_device(self) -> torch.device:
        """This process's device: its own position's over a process
        group, the grid's first in one process."""
        if not self.distributed:
            return self.devices.flat[0]
        return self.devices[tuple(self.coords.values())]

    def group(self, axis: str):
        """This rank's process group along `axis`."""
        return self.groups[axis]

    @property
    def origin(self) -> int | None:
        """The rank at position 0 of every axis (None in one process)."""
        return None if self.ranks is None else int(self.ranks.flat[0])

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
    prod(sizes) devices and raises when it is given fewer. Over an
    initialised process group of prod(sizes) ranks, devices[r] is rank
    r's device (None: cuda:(r mod the cards of a host), raising without
    one), and every rank creates every axis line's group, in the same
    order: every rank must call make_mesh with the same axes. Otherwise
    the mesh is this process's (devices None: every CUDA device)."""
    shape = tuple(axes.values())
    n = math.prod(shape)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else None)
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif world == n:
        cards = cuda_devices()
        devs = [cards[r % len(cards)] for r in range(n)]
    else:
        devs = cuda_devices()
    if n > len(devs):
        raise ValueError(
            f"mesh {dict(axes)} needs {n} devices, have {len(devs)}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    names = tuple(axes.keys())
    if world != n:
        return Mesh(grid.reshape(shape), names)
    ranks = np.arange(n).reshape(shape)
    rank = dist.get_rank()
    groups = {}
    for i, axis in enumerate(names):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    # A one-axis mesh's line is every rank already.
    everyone = (groups[names[0]] if len(names) == 1
                else dist.new_group(list(range(n))))
    return Mesh(grid.reshape(shape), names, ranks, rank, groups, everyone)
