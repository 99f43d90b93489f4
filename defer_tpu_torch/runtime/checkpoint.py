"""Checkpoint save/resume over the codec (counterpart of
`defer_tpu/runtime/checkpoint.py`; the files are the same bytes, so
either package loads what the other saved).

The reference has no checkpointing at all — weights flow dispatcher ->
node once at startup (reference src/dispatcher.py:60-63, src/node.py:
68-70) and are lost with the process. Here params (any nested
str-keyed dict of tensors: GraphParams, decoder params) serialize to a
single self-describing file, each array compressed through the runtime
codec (runtime/codec.py).

bfloat16 ships as a uint16 bit view with its logical dtype recorded in
the manifest, as the JAX package writes it.

File: magic line, 8-byte LE manifest length, JSON manifest
[{key, dtype, frame_len}...], then the codec frames back-to-back.

A training state (`parallel/train.py` `TrainState`: params, a
torch.optim optimizer, the step) checkpoints through the same pytree
files: `save_train_state` writes params, the optimizer's `state_dict()`
and the step; `load_train_state` restores them in place, so a resumed
run continues bit for bit.

Sharded checkpoints, `save_sharded` / `restore_sharded`: every rank
of a `torch.distributed` group writes one file holding only the shards
it owns, in the JAX package's format (one
`shards-{rank:05d}-of-{world:05d}.defer` a process, a manifest of
`process`, `save_id` and `entries` of `key`, `dtype`, `global_shape`,
`spans`, `frame_len`), so either package restores the other's
directory. A torch tensor carries no sharding: the caller names each
leaf's placement as the port's specs do (a tuple of mesh axis names, or
None, a dim; a dim may split over several axes, the first major) with
`specs=` and `mesh=`, the leaves being this rank's shards; a leaf
without a spec is whole. `save_sharded_train_state` /
`restore_sharded_train_state` checkpoint a `parallel/train.py`
`TrainState` over a process group this way, a `MeshOptimizer`'s ZeRO-1
moments as the data-axis slices they are.

`save_dcp` / `load_dcp` write and read a tree through
`torch.distributed.checkpoint`, the torch ecosystem's own format (the
port's counterpart of the JAX package's orbax interop, `save_orbax` /
`load_orbax`).
"""

from __future__ import annotations

import copy
import json
import math
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from defer_tpu_torch.parallel.mesh import cuda_devices
from defer_tpu_torch.parallel.pipeline import resolve_device
from defer_tpu_torch.runtime import codec

_MAGIC = b"DEFERTPU-CKPT-v1\n"
_SEP = "/"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    for k in sorted(tree):
        if _SEP in k:
            raise ValueError(f"checkpoint keys may not contain {_SEP!r}: {k!r}")
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.extend(_flatten(v, f"{path}{_SEP}"))
        else:
            out.append((path, v))
    return out


def _unflatten(items: list[tuple[str, Any]]) -> dict:
    root: dict = {}
    for path, v in items:
        parts = path.split(_SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def save_checkpoint(path: str, params: Mapping[str, Any], *, level: int = 3) -> None:
    """Atomically write `params` (tensors on any device, or numpy
    arrays) to `path` (write temp + rename)."""
    entries = []
    frames = []
    for key, value in _flatten(params):
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu()
        else:
            t = torch.as_tensor(np.asarray(value))
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            # The bit pattern as uint16, the JAX package's layout.
            t = t.view(torch.int16).numpy().view(np.uint16)
        frame = codec.encode(t, level=level)
        entries.append({"key": key, "dtype": logical, "frame_len": len(frame)})
        frames.append(frame)
    manifest = json.dumps(entries).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(manifest)))
        f.write(manifest)
        for frame in frames:
            f.write(frame)
    os.replace(tmp, path)


def load_checkpoint(path: str, *, device: Any = None) -> dict:
    """Read a checkpoint back into a nested dict of tensors on `device`
    (default: the first CUDA device; raises without one unless asked for
    the CPU)."""
    dev = resolve_device(device) if device is not None else cuda_devices()[0]
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path!r} is not a defer_tpu checkpoint")
        (mlen,) = struct.unpack("<q", f.read(8))
        entries = json.loads(f.read(mlen).decode())
        items = []
        for e in entries:
            t = codec.decode(f.read(e["frame_len"]))
            if e["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            items.append((e["key"], t.to(dev)))
    return _unflatten(items)


# -- arbitrary trees (params + optimizer state + step) ----------------------


def _leaves(tree: Any) -> list[Any]:
    """Leaves in the JAX package's tree order: dict keys sorted, lists
    and tuples (named or not) in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(template: Any, leaves: Any) -> Any:
    if template is None:
        return None
    if isinstance(template, Mapping):
        built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return type(template)((k, built[k]) for k in template)
    if isinstance(template, (list, tuple)):
        items = [_rebuild(v, leaves) for v in template]
        if hasattr(template, "_fields"):  # a NamedTuple
            return type(template)(*items)
        return type(template)(items)
    leaf = next(leaves)
    if isinstance(template, (bool, int, float)):
        # A Python scalar (an optimizer's hyperparameter) comes back as
        # one, not as the 0-d tensor the file holds.
        return type(template)(leaf.item())
    return leaf


def save_pytree(path: str, tree: Any, *, level: int = 3) -> None:
    """Checkpoint any tree of dicts, lists and tuples (e.g. params +
    optimizer state + step counter) by flattening it to leaves.

    The tree *structure* is not serialized — restore requires a
    template with the same structure (`load_pytree`). The leaf order is
    the JAX package's, so a file saved by either loads in the other
    against the same structure."""
    save_checkpoint(
        path,
        {"__leaves__": {str(i): leaf for i, leaf in enumerate(_leaves(tree))}},
        level=level,
    )


def load_pytree(path: str, template: Any, *, device: Any = None) -> Any:
    """Restore a tree saved by save_pytree into `template`'s structure
    (values of `template` are ignored; shapes/dtypes of the stored
    leaves win, but a Python bool/int/float template leaf comes back as
    its type). Raises if the leaf count doesn't match."""
    stored = load_checkpoint(path, device=device)["__leaves__"]
    n = len(_leaves(template))
    if n != len(stored):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves but the template "
            f"structure expects {n}"
        )
    return _rebuild(template, iter(stored[str(i)] for i in range(n)))


# -- training states (parallel/train.py TrainState) -------------------------


def _optimizer_template(opt: torch.optim.Optimizer) -> dict:
    """A state_dict with the structure `opt`'s takes once every
    parameter has state: its own when it has, else that of a copy
    stepped once on zero gradients (torch optimizers create their
    state at the first step; only the structure is read)."""
    n = sum(len(g["params"]) for g in opt.param_groups)
    if len(opt.state) == n:
        return opt.state_dict()
    shadow = copy.deepcopy(opt)
    for group in shadow.param_groups:
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    shadow.step()
    return shadow.state_dict()


def save_train_state(path: str, state: Any, *, level: int = 3) -> None:
    """Checkpoint a TrainState: {"params", "opt_state": the optimizer's
    state_dict(), "step"} through save_pytree."""
    save_pytree(path, {"params": state.params,
                       "opt_state": state.opt_state.state_dict(),
                       "step": state.step}, level=level)


def _copy_into(dst: Any, src: Any) -> None:
    """Copy a tree of tensors into one of the same structure, in place."""
    if isinstance(dst, Mapping):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def load_train_state(path: str, state: Any) -> Any:
    """Restore a save_train_state file into `state` in place (params and
    step copied into their tensors, the optimizer through
    load_state_dict, which places its moments beside their params) and
    return it. `state` gives the structure: a TrainState built the way
    the saved one was (its values are overwritten)."""
    template = {"params": state.params,
                "opt_state": _optimizer_template(state.opt_state),
                "step": state.step}
    tree = load_pytree(path, template, device="cpu")
    with torch.no_grad():
        _copy_into(state.params, tree["params"])
        state.step.copy_(tree["step"])
    state.opt_state.load_state_dict(tree["opt_state"])
    return state


# -- sharded checkpoints (one file a rank) ---------------------------------


def _flatten_pytree_keys(tree: Any) -> list[tuple[str, Any]]:
    """("a/b/0", leaf) pairs in the JAX package's key-path order: dict
    keys sorted, NamedTuple fields by name, lists and tuples by index,
    None an empty subtree; a bare leaf is "__root__"."""
    out: list[tuple[str, Any]] = []

    def walk(node, segs):
        if node is None:
            return
        if isinstance(node, Mapping):
            items = [(str(k), node[k]) for k in sorted(node)]
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            items = list(zip(node._fields, node))
        elif isinstance(node, (list, tuple)):
            items = [(str(i), v) for i, v in enumerate(node)]
        else:
            out.append((_SEP.join(segs) or "__root__", node))
            return
        for seg, value in items:
            if _SEP in seg:
                raise ValueError(
                    f"checkpoint keys may not contain {_SEP!r}: {seg!r}"
                )
            walk(value, segs + [seg])

    walk(tree, [])
    return out


def _flatten_specs(specs: Any) -> dict[str, Any]:
    """{key path: spec} of a spec tree mirroring a checkpoint tree's
    dicts; a spec is a tuple (one entry a dim) or None."""
    out: dict[str, Any] = {}

    def walk(node, segs):
        if isinstance(node, Mapping):
            for k in node:
                walk(node[k], segs + [str(k)])
        else:
            out[_SEP.join(segs) or "__root__"] = node

    if specs is not None:
        walk(specs, [])
    return out


def _dim_axes(entry) -> tuple:
    """The mesh axes one spec entry splits its dim over, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _layout(spec, local_shape, mesh) -> tuple[tuple, tuple, bool]:
    """(global shape, this rank's spans, whether this rank stores the
    leaf) of a leaf this rank holds as `local_shape` under `spec`: each
    split dim grows by its axes' sizes and this rank's span is its
    mixed-radix index along them; the stored copy of data replicated
    over an axis is the one at coordinate 0 there (the JAX package's
    replica_id == 0)."""
    spec = tuple(spec or ())
    shape = tuple(int(d) for d in local_shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    coords = mesh.coords if mesh is not None else {}
    sizes = mesh.shape if mesh is not None else {}
    gshape, spans, split = [], [], set()
    for i, dim in enumerate(shape):
        axes = _dim_axes(spec[i]) if i < len(spec) else ()
        index, n = 0, 1
        for ax in axes:
            index = index * sizes[ax] + coords[ax]
            n *= sizes[ax]
        split.update(axes)
        gshape.append(dim * n)
        spans.append((index * dim, (index + 1) * dim))
    owner = all(coords[a] == 0 for a in coords if a not in split)
    return tuple(gshape), tuple(spans), owner


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _process() -> tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) alone."""
    return (dist.get_rank(), dist.get_world_size()) if _joined() else (0, 1)


def _host_leaf(value) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its logical dtype name (bf16 as
    its uint16 bit view, the JAX package's layout)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
    elif isinstance(value, bool):
        t = torch.tensor(value)
    elif isinstance(value, (int, float)):
        # jnp.asarray's types for a Python scalar.
        t = torch.tensor(value, dtype=torch.int32 if isinstance(value, int)
                         else torch.float32)
    else:
        t = torch.as_tensor(np.asarray(value))
    logical = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), logical
    return t.numpy(), logical


def save_sharded(dirpath: str, tree: Any, *, level: int = 3,
                 save_id: Any = None, specs: Any = None,
                 mesh: Any = None) -> None:
    """Checkpoint a tree of this rank's shards without gathering: each
    rank of the process group (or the one process) writes one file
    holding only the shards it owns, each leaf's replicated copies
    stored once across the job (the rank at coordinate 0 on every mesh
    axis that its spec does not split writes it). The JAX package's
    `save_sharded`, file for file: `specs=` (a tree of the port's specs
    mirroring `tree`'s dicts) and `mesh=` say how each leaf is split,
    since a torch tensor carries no sharding; a leaf without a spec is
    whole, and the origin rank writes it. Assumes a filesystem every
    rank can read at restore.

    `save_id` (e.g. the training step, a value every rank already
    agrees on) is stamped into each file's manifest; restore_sharded
    rejects shard sets with mismatched ids, catching a save that died
    after only some ranks replaced their files."""
    os.makedirs(dirpath, exist_ok=True)
    spec_of = _flatten_specs(specs)
    entries = []
    frames = []
    for key, value in _flatten_pytree_keys(tree):
        arr, logical = _host_leaf(value)
        gshape, spans, owner = _layout(spec_of.get(key), arr.shape, mesh)
        if not owner:
            continue
        frame = codec.encode(np.ascontiguousarray(arr), level=level)
        entries.append({
            "key": key,
            "dtype": logical,
            "global_shape": gshape,
            "spans": spans,
            "frame_len": len(frame),
        })
        frames.append(frame)
    rank, world = _process()
    manifest = json.dumps(
        {"process": rank, "save_id": save_id, "entries": entries}
    ).encode()
    # The process count rides in the filename so a restore can detect
    # stale shard files from an earlier save with a different job size.
    path = os.path.join(dirpath, f"shards-{rank:05d}-of-{world:05d}.defer")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(manifest)))
        f.write(manifest)
        for frame in frames:
            f.write(frame)
    os.replace(tmp, path)


def restore_sharded(dirpath: str, like: Any, *, specs: Any = None,
                    mesh: Any = None) -> Any:
    """Rebuild this rank's shards of a tree from a save_sharded
    directory (either package's). `like` carries the structure and this
    rank's shards' shapes and devices (e.g. a freshly built state);
    `specs=` / `mesh=` as for save_sharded give each leaf's placement,
    and a leaf without a spec is restored whole. Each rank reads every
    file's manifest and decodes only the spans it places; the stored
    dtypes win. Refuses a directory with no shard files, a mixed or
    incomplete set, mixed save ids, a missing leaf, and a span no
    stored shard covers, in the JAX package's words."""
    names = sorted(
        n for n in os.listdir(dirpath)
        if n.startswith("shards-") and n.endswith(".defer")
    )
    if not names:
        raise FileNotFoundError(f"no shard files under {dirpath!r}")
    counts = {n.rsplit("-of-", 1)[-1] for n in names}
    if len(counts) != 1 or len(names) != int(counts.pop().split(".")[0]):
        raise ValueError(
            f"{dirpath!r} holds a mixed or incomplete shard set "
            f"({names}); remove stale files from a previous save"
        )
    spec_of = _flatten_specs(specs)
    flat_like = _flatten_pytree_keys(like)
    # key -> (the span this rank places, or None when whole; its shape)
    placed: dict[str, tuple] = {}
    needed: dict[str, set] = {}
    for key, leaf in flat_like:
        local = tuple(int(d) for d in leaf.shape)
        spec = spec_of.get(key)
        gshape, spans, _ = _layout(spec, local, mesh)
        full = tuple((0, d) for d in gshape)
        sharded = any(_dim_axes(e) for e in (spec or ()))
        placed[key] = (spans if sharded else None, gshape)
        needed[key] = {full, spans}

    pieces: dict[str, dict[tuple, torch.Tensor]] = {}
    save_ids: set = set()
    for name in names:
        with open(os.path.join(dirpath, name), "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{name!r} is not a defer_tpu checkpoint")
            (mlen,) = struct.unpack("<q", f.read(8))
            header = json.loads(f.read(mlen).decode())
            save_ids.add(json.dumps(header.get("save_id")))
            if len(save_ids) > 1:
                raise ValueError(
                    f"{dirpath!r} mixes shards from different saves "
                    f"(save_ids {sorted(save_ids)}); a previous save "
                    "likely died after replacing only some files"
                )
            for e in header["entries"]:
                span = tuple(tuple(sp) for sp in e["spans"])
                if span not in needed.get(e["key"], ()):
                    f.seek(e["frame_len"], os.SEEK_CUR)
                    continue
                t = codec.decode(f.read(e["frame_len"]))
                if e["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                pieces.setdefault(e["key"], {})[span] = t
    leaves = []
    for key, leaf in flat_like:
        by_span = pieces.get(key)
        if by_span is None:
            raise KeyError(f"checkpoint has no shards for leaf {key!r}")
        span, gshape = placed[key]
        if span is None:
            piece = by_span.get(tuple((0, d) for d in gshape))
            if piece is None:
                raise ValueError(
                    f"leaf {key!r} has no full-array shard and no "
                    "target sharding to assemble against"
                )
        else:
            piece = by_span.get(span)
            if piece is None:
                raise ValueError(
                    f"leaf {key!r}: no stored shard covers span {span} "
                    f"(stored: {sorted(by_span)[:4]}...)"
                )
        # The codec round-trips data, not rank (0-d arrays come back
        # 1-element); restore the span's exact shape.
        shape = tuple(b - a for a, b in (span or tuple(
            (0, d) for d in gshape)))
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        leaves.append(piece.reshape(shape).to(device))
    # _flatten_pytree_keys walks in _leaves's order.
    return _rebuild(like, iter(leaves))


def _sharded_state(state: Any, model: Any) -> tuple[dict, dict, dict]:
    """(tree, specs, the optimizer's state_dict template) of a TrainState
    over `model`'s mesh (SpmdBert and its kin): params, the step and the
    optimizer's per-parameter state by index, each moment placed as its
    parameter (a ZeRO-1 slice's on the data axis too,
    `MeshOptimizer.state_specs`)."""
    opt = state.opt_state
    inner = getattr(opt, "inner", opt)
    full = _optimizer_template(inner)
    # Fresh per-parameter dicts: a stepped optimizer's state_dict shares
    # its live ones.
    template = {"state": {i: dict(e) for i, e in full["state"].items()},
                "param_groups": full["param_groups"]}
    if hasattr(opt, "state_specs"):
        leaf_specs = opt.state_specs()
    else:
        leaf_specs = [None] * len(template["state"])
    moments = {}
    moment_specs = {}
    for i, entry in template["state"].items():
        moments[str(i)] = {k: v for k, v in entry.items()
                           if isinstance(v, torch.Tensor)}
        moment_specs[str(i)] = {
            k: (leaf_specs[i] if v.ndim else ())
            for k, v in moments[str(i)].items()
        }
    tree = {"params": state.params, "step": state.step, "opt": moments}
    specs = {"params": model.param_specs(state.params), "step": (),
             "opt": moment_specs}
    return tree, specs, template


def save_sharded_train_state(dirpath: str, state: Any, model: Any, *,
                             level: int = 3, save_id: Any = None) -> None:
    """save_sharded of a TrainState over `model`'s mesh, every rank
    calling it: each rank writes the shards of the params, the step and
    the optimizer's moments it owns (a ZeRO-1 MeshOptimizer's moments
    are this data rank's slices, stored as such). The optimizer must
    have stepped (its state exists)."""
    tree, specs, _ = _sharded_state(state, model)
    save_sharded(dirpath, tree, level=level, save_id=save_id, specs=specs,
                 mesh=model.mesh)


def restore_sharded_train_state(dirpath: str, state: Any, model: Any) -> Any:
    """Restore a save_sharded_train_state directory into `state` in
    place (params and step copied into their tensors, the optimizer
    through load_state_dict) and return it; `state` is built the way
    the saved one was, over the same layout. A resumed run continues
    bit for bit."""
    tree, specs, template = _sharded_state(state, model)
    got = restore_sharded(dirpath, tree, specs=specs, mesh=model.mesh)
    with torch.no_grad():
        _copy_into(state.params, got["params"])
        state.step.copy_(got["step"])
    for i, entry in template["state"].items():
        entry.update(got["opt"][str(i)])
    inner = getattr(state.opt_state, "inner", state.opt_state)
    inner.load_state_dict(template)
    return state


# -- torch.distributed.checkpoint interop -----------------------------------


def save_dcp(path: str, tree: Mapping[str, Any]) -> None:
    """Write a tree of tensors (nested dicts) as a
    `torch.distributed.checkpoint` directory, the torch ecosystem's own
    format, so training stacks standardized on it can read the port's
    states (the counterpart of the JAX package's `save_orbax`, which
    writes orbax's). Over a process group every rank calls it (plain
    tensors are saved as replicated: one copy); in one process it needs
    no group. The native formats (save_pytree, save_sharded) stay the
    default."""
    import torch.distributed.checkpoint as dcp

    dcp.save(dict(tree), checkpoint_id=os.path.abspath(path),
             no_dist=not _joined())


def load_dcp(path: str, template: Mapping[str, Any]) -> dict:
    """The inverse of save_dcp (the JAX package's `load_orbax`):
    `template` supplies the structure, shapes and dtypes, and its
    placement wins: each leaf comes back on its template leaf's device,
    whatever the file recorded."""
    import torch.distributed.checkpoint as dcp

    def fresh(node):
        if isinstance(node, Mapping):
            return {k: fresh(v) for k, v in node.items()}
        return torch.empty_like(node)

    out = fresh(template)
    dcp.load(out, checkpoint_id=os.path.abspath(path), no_dist=not _joined())
    return out
