"""The stage pipeline over a mesh's "stage" axis (counterpart of
`defer_tpu/parallel/spmd_pipeline.py`: `make_spmd_pipeline`,
`stack_for_stages`, `staged_specs`, and the inverse `unstack_stages`).

The JAX package runs one shard_map program on every core: each step
every stage applies its layers and `lax.ppermute` rotates the
activations one hop, M microbatches draining in M + S - 1 steps, the
bubble steps' results masked away. The port runs that function in one
of two forms, by the mesh (`parallel/mesh.py`):

  * over a process group, one rank per mesh position: the JAX loop as
    it is. Each rank holds its own stage's layers ([1, L/S, ...] leaves,
    `transformer_stack.shard_tree`), computes all M + S - 1 steps (the
    bubble steps too), hops the activation with `collectives.ppermute`,
    and the last stage's emissions, masked on every other stage, are
    psum-reduced over the stage axis. The microbatches' batch dim splits
    over `data_axis` and their sequence dim over `seq_axis`, and the
    result comes back whole on every rank (`collectives.unshard`).
    Autograd differentiates the loop: ppermute's backward is the
    inverse hop, so the backward needs no schedule of its own;
  * in one process (every position this process's, only "stage" larger
    than 1): each microbatch of [M, B, ...] runs stage 0 to S-1 in
    order, stage s on the mesh's stage-s device, the activation moving
    between stages with `.to(..., non_blocking=True)` (no copy when two
    stages share a card). No bubble step is computed.

Parameters stay stage-stacked, [S, L/S, ...] leaves, so a JAX tree
crosses with `weights.params_from_jax` unchanged; stage s reads
`leaf[s]`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.mesh import Mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_spmd_pipeline(
    mesh: Mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    stage_axis: str = "stage",
    data_axis: str | None = None,
    seq_axis: str | None = None,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build the pipelined function.

    stage_fn(stage-local params, activation [B, ...]) -> activation of
    the same shape; over a process group it runs with `mesh` active, so
    it may call the collectives over the mesh's other axes (the tp
    psums, ring attention over "seq"). data_axis / seq_axis split the
    microbatches' dims 1 and 2 (batch, sequence) over those axes;
    stage_fn then sees the local shard. Returns run(stacked_params, xs):
    xs [M, B, ...] -> ys [M, B, ...] on xs's device, exactly
    microbatch-sized."""
    if mesh.distributed:
        return _rank_pipeline(mesh, stage_fn, stage_axis, data_axis,
                              seq_axis)
    devices = mesh.axis_devices(stage_axis)

    def run(stacked: Any, xs: torch.Tensor) -> torch.Tensor:
        stages = [
            _tree_map(lambda a, s=s, d=d: a[s].to(d, non_blocking=True),
                      stacked)
            for s, d in enumerate(devices)
        ]
        ys = []
        for m in range(xs.shape[0]):
            x = xs[m]
            for d, params in zip(devices, stages):
                x = stage_fn(params, x.to(d, non_blocking=True))
            ys.append(x.to(xs.device, non_blocking=True))
        return torch.stack(ys)

    return run


def _rank_pipeline(mesh, stage_fn, stage_axis, data_axis, seq_axis):
    """The JAX loop over a process group (module docstring)."""
    num_stages = mesh.shape[stage_axis]
    st = stage_axis if num_stages > 1 else None
    shift = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    splits = [(1, data_axis), (2, seq_axis)]

    def run(stacked: Any, xs: torch.Tensor) -> torch.Tensor:
        with collectives.active(mesh):
            local = _tree_map(lambda a: a[0], stacked)
            # Replicated over the stage axis, read by stage 0 alone: its
            # cotangent is summed over the stages (the embedding's
            # gradient reaches every rank).
            xs = collectives.pvary(xs, st)
            for dim, axis in splits:  # raises on every rank, before any
                xs = collectives.shard(xs, axis, dim)  # collective runs
            if st is None:
                ys = torch.stack([stage_fn(local, x) for x in xs])
            else:
                ys = _stage_loop(local, xs, stage_fn, st, num_stages, shift)
            for dim, axis in reversed(splits):
                ys = collectives.unshard(ys, axis, dim)
            return ys

    return run


def _stage_loop(local, xs, stage_fn, st, num_stages, shift):
    """M + S - 1 steps: stage 0 injects microbatch t, every other stage
    takes what its left neighbour pushed last step; the last stage's
    steady-state tail is the output. Every rank runs the same ops (the
    rank picks through torch.where), so the backward's collectives come
    in the same order on every rank."""
    stage = collectives.axis_index(st)
    first = torch.tensor(stage == 0, device=xs.device)
    last = torch.tensor(stage == num_stages - 1, device=xs.device)
    num_mb = xs.shape[0]
    steps = num_mb + num_stages - 1
    carry = torch.zeros_like(xs[0])
    emits = []
    for t in range(steps):
        out = stage_fn(local, torch.where(first, xs[min(t, num_mb - 1)],
                                          carry))
        emits.append(out)
        if t < steps - 1:  # the last step's hop would carry nothing used
            carry = collectives.ppermute(out, st, shift)
    tail = torch.stack(emits[num_stages - 1:])
    return collectives.psum(torch.where(last, tail, torch.zeros_like(tail)),
                            st)


def check_process_group(mesh: Mesh, stage_axis: str = "stage") -> None:
    """Refuse a one-process mesh with any axis but `stage_axis` larger
    than 1: data, tensor, sequence and expert parallelism run one
    process per mesh position, over a process group."""
    if mesh.distributed:
        return
    for axis, size in mesh.shape.items():
        if axis != stage_axis and size > 1:
            raise RuntimeError(
                f"mesh axis {axis!r} of size {size} needs one process "
                "per mesh position: call "
                "defer_tpu_torch.parallel.multihost.initialize() in every "
                "rank before make_mesh (in one process only the "
                f"{stage_axis!r} axis may be larger than 1)"
            )


def stack_for_stages(params: Any, num_stages: int) -> Any:
    """Reshape leading [L, ...] leaves to [S, L // S, ...], the layout
    the stage axis splits."""

    def reshape(leaf):
        L = leaf.shape[0]
        if L % num_stages:
            raise ValueError(
                f"layer count {L} not divisible by {num_stages} stages"
            )
        return leaf.reshape(num_stages, L // num_stages, *leaf.shape[1:])

    return _tree_map(reshape, params)


def unstack_stages(params: Any) -> Any:
    """The inverse of stack_for_stages: [S, L/S, ...] -> [L, ...], the
    layout the KV-cache decoder (models/gpt.py) and the unpipelined
    references read."""
    return _tree_map(lambda a: a.reshape(-1, *a.shape[2:]), params)


def staged_specs(specs: Any, stage_axis: str = "stage") -> Any:
    """Prepend the stage axis to per-layer specs (for stack_for_stages
    output): (a, b, ...) -> (stage, a, b, ...)."""
    return _tree_map(lambda spec: (stage_axis, *spec), specs)
