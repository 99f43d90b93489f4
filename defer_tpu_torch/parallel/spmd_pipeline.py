"""The stage pipeline over a mesh's "stage" axis (counterpart of
`defer_tpu/parallel/spmd_pipeline.py`: `make_spmd_pipeline`,
`stack_for_stages`, and its inverse `unstack_stages`).

The JAX package runs one shard_map program on every core: each step
every stage applies its layers and `lax.ppermute` rotates the
activations one hop, M microbatches draining in M + S - 1 steps, the
bubble steps' results masked away. In one process the same function is
a loop: each microbatch of [M, B, ...] runs stage 0 to S-1 in order,
stage s on the mesh's stage-s device, the activation moving between
stages with `.to(..., non_blocking=True)` (no copy when two stages
share a card). No bubble step is computed. Autograd differentiates the
loop as it stands, so the backward needs no schedule of its own.

Parameters stay stage-stacked, [S, L/S, ...] leaves, so a JAX tree
crosses with `weights.params_from_jax` unchanged; stage s reads
`leaf[s]` (on its own device). The PartitionSpecs (`staged_specs`)
wait for the collectives of ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

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
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build the pipelined function.

    stage_fn(stage-local params, activation [B, ...]) -> activation of
    the same shape. Returns run(stacked_params, xs): xs [M, B, ...] ->
    ys [M, B, ...] on xs's device, exactly microbatch-sized."""
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


def check_stage_only(mesh: Mesh, stage_axis: str = "stage") -> None:
    """Refuse a mesh with any axis but `stage_axis` larger than 1: in one
    process only the stages run; data, tensor, sequence and expert
    parallelism need the collectives of ROADMAP Queue 1 item 7."""
    for axis, size in mesh.shape.items():
        if axis != stage_axis and size > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {size}: only the "
                f"{stage_axis!r} axis may be larger than 1 here; the "
                "collectives behind the other axes are not ported yet "
                "(ROADMAP Queue 1 item 7)"
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
