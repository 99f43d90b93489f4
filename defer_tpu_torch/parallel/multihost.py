"""Multi-process initialization and mesh layout (counterpart of
`defer_tpu/parallel/multihost.py`).

The JAX package joins a `jax.distributed` job; here every rank joins one
`torch.distributed` process group, one process per mesh position
(`parallel/mesh.py`), and the collectives ride that group's backend:

    # torchrun --nproc-per-node 8 train.py   (sets RANK, WORLD_SIZE,
    # LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    from defer_tpu_torch.parallel import multihost
    multihost.initialize()                    # NCCL, cuda:LOCAL_RANK
    mesh = make_mesh({"stage": 2, "model": 4})

The backend is explicit: NCCL (the default) needs a card of its own for
every rank of a host, and refuses two ranks on one card. Ranks that
share a card (or run on the CPU) pass backend="gloo"; `initialize`
raises where NCCL cannot work rather than switching backend by itself.

The layout rule is the JAX package's: axes that communicate most
(model, seq, expert) stay inside a host; only data and stage may span
hosts (`dcn_aware_axes`).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from defer_tpu_torch.parallel.mesh import Mesh, make_mesh
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _env_int(name: str, given: int | None) -> int | None:
    if given is not None:
        return given
    value = os.environ.get(name)
    return int(value) if value is not None else None


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str = "nccl",
    local_rank: int | None = None,
) -> dict:
    """Join (or bootstrap) the process group of a multi-process run.

    The arguments default to torchrun's environment: WORLD_SIZE, RANK,
    LOCAL_RANK, and MASTER_ADDR / MASTER_PORT for the default
    init_method ("env://"); e.g. initialize("tcp://localhost:29500", 2,
    r, backend="gloo") without it. Idempotent: a second call in a
    process that has joined returns the topology and changes nothing.
    With neither a world size nor an init_method it is a single-process
    run and joins nothing.

    backend="nccl" binds this rank to cuda:local_rank and raises, before
    joining, when the host has no such card or fewer cards than
    LOCAL_WORLD_SIZE ranks (NCCL refuses two ranks on one card: pass
    backend="gloo" there). Returns the topology snapshot."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: must be 'nccl' or 'gloo'")
    if not dist.is_initialized():
        world_size = _env_int("WORLD_SIZE", world_size)
        rank = _env_int("RANK", rank)
        local_rank = _env_int("LOCAL_RANK", local_rank)
        if world_size is None and init_method is None:
            log.info("single-process run; no process group joined")
            return topology()
        if world_size is None or rank is None:
            raise ValueError(
                "initialize needs world_size and rank (or WORLD_SIZE and "
                "RANK in the environment, as torchrun sets them)"
            )
        if backend == "nccl":
            local = rank if local_rank is None else local_rank
            cards = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            per_host = _env_int("LOCAL_WORLD_SIZE", None) or 0
            if max(local + 1, per_host) > cards:
                raise RuntimeError(
                    f"backend='nccl' puts local rank {local} on cuda:"
                    f"{local} (of {max(local + 1, per_host)} ranks on "
                    f"this host), and it has {cards} CUDA device(s): "
                    "NCCL needs a card of its own for every rank of a "
                    "host. Ranks that share a card, or run on the CPU, "
                    "pass backend='gloo'"
                )
            torch.cuda.set_device(local)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
        )
    topo = topology()
    log.info("multihost topology: %s", topo)
    return topo


def topology() -> dict:
    """This process's place in the run: rank, world size, its local
    cards, and the number of hosts (world size over LOCAL_WORLD_SIZE,
    as torchrun sets it; 1 without it)."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": world,
        "backend": dist.get_backend() if joined else None,
        "local_devices": (torch.cuda.device_count()
                          if torch.cuda.is_available() else 0),
        "num_hosts": max(1, world // max(1, local_world)),
    }


def dcn_aware_axes(
    axes: Mapping[str, int], *, dcn_axes: Sequence[str] = ("data", "stage")
) -> dict[str, int]:
    """Order mesh axes so only the named outer axes cross hosts.

    Rank r sits at np.unravel_index(r, shape) and torchrun numbers the
    ranks of a host contiguously, so the leading axes are the ones that
    span hosts. Axes with heavy collectives (model, seq, expert) stay
    inner so their traffic stays on a host's links; data and stage move
    one activation boundary or one gradient reduction a step, so those
    may cross hosts."""
    hosts = topology()["num_hosts"]
    if hosts <= 1:
        return dict(axes)
    outer = {k: v for k, v in axes.items() if k in dcn_axes}
    inner = {k: v for k, v in axes.items() if k not in dcn_axes}
    outer_size = int(np.prod(list(outer.values()))) if outer else 1
    if outer_size % hosts != 0 and outer_size != 1:
        log.warning(
            "outer axes %s (size %d) do not tile the %d hosts evenly; "
            "an intra-host axis may end up crossing hosts",
            tuple(outer), outer_size, hosts,
        )
    return {**outer, **inner}


def make_multihost_mesh(
    axes: Mapping[str, int],
    *,
    dcn_axes: Sequence[str] = ("data", "stage"),
) -> Mesh:
    """make_mesh with the host-aware axis ordering applied."""
    return make_mesh(dcn_aware_axes(axes, dcn_axes=dcn_axes))


def stage_submeshes(mesh: Mesh, stage_axis: str = "stage") -> list:
    """Split a mesh with an outermost `stage_axis` into one mesh per
    stage over that stage's devices, the remaining axes in order (the
    JAX package's layout for pp around tp). Over a process group the
    submesh of this rank's stage keeps its rank and its groups along the
    remaining axes (the lines of the whole mesh that lie inside the
    stage), so a stage's collectives stay among its own ranks; another
    stage's submesh carries its ranks but no rank and no groups."""
    if stage_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {stage_axis!r} axis (axes: {mesh.axis_names}); "
            f"build it with make_multihost_mesh({{{stage_axis!r}: S, "
            "...}})"
        )
    if mesh.axis_names.index(stage_axis) != 0:
        raise ValueError(
            f"{stage_axis!r} must be the OUTERMOST mesh axis so each "
            "stage's devices are contiguous (dcn_aware_axes puts it "
            f"there); got axis order {mesh.axis_names}"
        )
    rest = tuple(n for n in mesh.axis_names if n != stage_axis)
    if not mesh.distributed:
        return [Mesh(mesh.devices[s], rest)
                for s in range(mesh.devices.shape[0])]
    mine = mesh.coords[stage_axis]
    out = []
    for s in range(mesh.devices.shape[0]):
        if s != mine:
            out.append(Mesh(mesh.devices[s], rest, mesh.ranks[s]))
            continue
        groups = {a: mesh.groups[a] for a in rest}
        # The stage's own ranks as one group: its only axis's line, or
        # (with more axes) no group of its own: nothing here runs one.
        everyone = groups[rest[0]] if len(rest) == 1 else None
        out.append(Mesh(mesh.devices[s], rest, mesh.ranks[s], mesh.rank,
                        groups, everyone))
    return out
