"""The SPMD stack's collectives on torch.distributed (the port's
counterpart of the `lax` collectives the JAX package calls inside
shard_map: `lax.psum`, `all_to_all`, `all_gather`, `ppermute`,
`axis_size`, `axis_index`).

A collective names a mesh axis. The active mesh (`active(mesh)`, which
the stage pipeline's run enters) maps the axis to this rank's process
group along it (`Mesh.group`); axis None is the identity, as the JAX
package skips the collective at an axis it does not shard over.

shard_map differentiates its collectives by itself; here each op is a
`torch.autograd.Function` whose backward is the transpose JAX takes:

  * `psum`: all_reduce forward, identity backward (the cotangent of a
    replicated value is already replicated);
  * `pvary`: identity forward, all_reduce backward. JAX inserts it
    implicitly where a value replicated over an axis enters a
    computation that differs along it (x before the column-parallel
    projections, the MoE inputs and router); without it those
    gradients come out partial;
  * `all_gather` (tiled): reduce-scatter (a sum) backward;
  * `all_to_all` (tiled): the inverse all_to_all backward;
  * `ppermute`: the inverse permutation backward;
  * `shard` / `unshard`, the entry into and the exit from a region
    split over an axis that divides the batch or the sequence (the
    shard_map's in_specs and out_specs): this rank's slice forward and
    the all_gather of the cotangent backward, and the reverse. A value
    whole on every rank before the region gets a whole gradient on
    every rank; the parameters read inside it get this rank's share,
    which `train.reduce_gradients` sums over the axis (JAX's implicit
    pvary of a replicated parameter).

Every rank calls every collective in the same order: the forward is the
same program on every rank, and a backward replays the graph in an order
fixed by its structure, which is the same on every rank (branches on the
rank go through `torch.where`, never through Python control flow around
a differentiable op).

Do not use `torch.distributed.nn.functional.all_reduce` for psum: its
backward all-reduces again, which scales these gradients by the axis
size.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "defer_tpu_torch_mesh", default=None
)


@contextlib.contextmanager
def active(mesh) -> Iterator:
    """Make `mesh` the mesh whose axes the collectives name."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh():
    return _ACTIVE.get()


def _line(axis: str):
    """(group, size, index) of this rank along `axis` of the active mesh.
    An axis of size 1 of a one-process mesh is (None, 1, 0): every
    collective over it is the identity, as lax's are over a size-1
    axis."""
    mesh = _ACTIVE.get()
    if (mesh is not None and not mesh.distributed
            and mesh.shape.get(axis) == 1):
        return None, 1, 0
    if mesh is None or not mesh.distributed:
        raise RuntimeError(
            f"a collective over mesh axis {axis!r} needs a mesh over a "
            "process group, active while it runs: call "
            "defer_tpu_torch.parallel.multihost.initialize() in every "
            "rank, then make_mesh"
        )
    return mesh.group(axis), mesh.shape[axis], mesh.coords[axis]


def axis_size(axis: str | None) -> int:
    """Size of a mesh axis (lax.axis_size); 1 for None."""
    return 1 if axis is None else _line(axis)[1]


def axis_index(axis: str | None) -> int:
    """This rank's index along a mesh axis (lax.axis_index); 0 for None."""
    return 0 if axis is None else _line(axis)[2]


def _dense(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


# -- the raw collectives (no autograd) -------------------------------------


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Tiled all_gather of x along `dim`, the ranks' chunks in order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Tiled reduce-scatter (sum) of x along `dim`: rank i keeps the sum
    of every rank's i-th chunk."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _exchange(x, group, n: int, split_axis: int, concat_axis: int):
    """Tiled all_to_all: chunk j of x along split_axis goes to rank j;
    the chunks received concatenate along concat_axis in rank order."""
    xt = x.movedim(split_axis, 0)
    xt = xt.reshape(n, xt.shape[0] // n, *xt.shape[1:]).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)],
                     dim=concat_axis)


def _permute(x, group, n: int, index: int, perm) -> torch.Tensor:
    """lax.ppermute along one axis: this rank sends x to the rank its
    (src, dst) pair names and receives from the one naming it; a rank
    nobody sends to gets zeros. One all_to_all_single whose splits are
    empty toward every other rank: the same call on every backend."""
    dst = [d for s, d in perm if s == index]
    src = [s for s, d in perm if d == index]
    flat = x.contiguous().reshape(1, -1)
    sends, recvs = [0] * n, [0] * n
    if dst:
        sends[dst[0]] = 1
    if src:
        recvs[src[0]] = 1
    out = flat.new_empty((len(src), flat.shape[1]))
    dist.all_to_all_single(out, flat[: len(dst)], recvs, sends, group=group)
    return out.reshape(x.shape) if src else torch.zeros_like(x)


# -- the differentiable collectives ----------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(_dense(x), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_dense(g), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, *ctx.args), None, None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (group, n, dim)
        c = x.shape[dim] // n
        return x.narrow(dim, index * c, c)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, *ctx.args), None, None, None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (index, dim, x.shape[dim])
        return gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        index, dim, c = ctx.args
        return g.narrow(dim, index * c, c), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _exchange(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, perm):
        ctx.args = (group, n, index, [(d, s) for s, d in perm])
        return _permute(x, group, n, index, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None, None


def psum(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Sum over a mesh axis (lax.psum): the tp partial sums, the ep sum,
    the stage loop's output."""
    if axis is None:
        return x
    group, _, _ = _line(axis)
    return x if group is None else _Psum.apply(x, group)


def pvary(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """The entry of a value replicated over `axis` into a computation
    that differs along it: identity forward, all_reduce backward."""
    if axis is None:
        return x
    group, _, _ = _line(axis)
    return x if group is None else _Pvary.apply(x, group)


def all_gather(x: torch.Tensor, axis: str | None, *, dim: int) -> torch.Tensor:
    """lax.all_gather(tiled=True): FSDP's just-in-time weights."""
    if axis is None:
        return x
    group, n, _ = _line(axis)
    return x if group is None else _AllGather.apply(x, group, n, dim)


def all_to_all(
    x: torch.Tensor, axis: str | None, *, split_axis: int, concat_axis: int
) -> torch.Tensor:
    """lax.all_to_all(tiled=True): the a2a dispatch's two routes and
    Ulysses' re-sharding between heads and positions."""
    if axis is None:
        return x
    group, n, _ = _line(axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def ppermute(
    x: torch.Tensor, axis: str | None, perm: Sequence[tuple[int, int]]
) -> torch.Tensor:
    """lax.ppermute over (src, dst) axis-index pairs: ring attention's
    K/V rotation and the stage loop's hop."""
    if axis is None:
        return x
    group, n, index = _line(axis)
    if group is None:
        return x
    return _Ppermute.apply(x, group, n, index, [tuple(p) for p in perm])


def shard(x: torch.Tensor, axis: str | None, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim`, split over `axis`, of an x whole on
    every rank; its backward all-gathers the cotangent."""
    if axis is None:
        return x
    group, n, index = _line(axis)
    if group is None:
        return x
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of shape {tuple(x.shape)} does not divide over "
            f"mesh axis {axis!r} of size {n}"
        )
    return _Shard.apply(x, group, n, index, dim)


def unshard(x: torch.Tensor, axis: str | None, dim: int) -> torch.Tensor:
    """The inverse of `shard`: x whole on every rank (all_gather); its
    backward keeps this rank's slice of the cotangent."""
    if axis is None:
        return x
    group, n, index = _line(axis)
    return x if group is None else _Unshard.apply(x, group, n, index, dim)
