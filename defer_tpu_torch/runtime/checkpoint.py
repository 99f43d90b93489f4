"""Checkpoint save/resume over the codec (counterpart of the flat half
of `defer_tpu/runtime/checkpoint.py`; the files are the same bytes, so
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

The sharded (multi-host) checkpoints, `save_sharded` /
`restore_sharded`, raise: they are not ported yet (ROADMAP.md Queue 1
item 7).
"""

from __future__ import annotations

import copy
import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

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

    def copy_into(dst, src):
        if isinstance(dst, Mapping):
            for k in dst:
                copy_into(dst[k], src[k])
        else:
            dst.copy_(src)

    with torch.no_grad():
        copy_into(state.params, tree["params"])
        state.step.copy_(tree["step"])
    state.opt_state.load_state_dict(tree["opt_state"])
    return state


def save_sharded(*args: Any, **kwargs: Any) -> None:
    """The JAX package's per-process sharded checkpoint: not ported yet,
    so it raises (ROADMAP Queue 1 item 7)."""
    raise NotImplementedError(
        "save_sharded (per-process sharded checkpoints) is not ported yet "
        "(ROADMAP Queue 1 item 7)"
    )


def restore_sharded(*args: Any, **kwargs: Any) -> Any:
    """The inverse of save_sharded: raises as it does."""
    raise NotImplementedError(
        "restore_sharded (per-process sharded checkpoints) is not ported "
        "yet (ROADMAP Queue 1 item 7)"
    )
