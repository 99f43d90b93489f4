"""The op registry: name -> (init, apply)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

NodeParams = Mapping[str, torch.Tensor]
InitFn = Callable[
    [torch.Generator, Mapping[str, Any], Sequence[tuple[int, ...]], Any],
    NodeParams,
]
ApplyFn = Callable[
    [NodeParams, Sequence[torch.Tensor], Mapping[str, Any]], torch.Tensor
]
PlaceFn = Callable[[NodeParams, Mapping[str, Any], Any], NodeParams]


@dataclasses.dataclass(frozen=True)
class Op:
    """An op kind.

    init(generator, attrs, in_shapes, param_dtype) -> params dict (maybe
      empty), drawn from `generator` on the generator's device
    apply(params, inputs, attrs) -> output tensor
    place(params, attrs, compute_dtype) -> params in the form `apply`
      reads fastest on a device, made once when a stage places its
      slice (parallel/pipeline.py); `apply` takes both forms
    """

    name: str
    init: InitFn
    apply: ApplyFn
    place: PlaceFn


_REGISTRY: dict[str, Op] = {}


def register_op(
    name: str, *, init: InitFn | None = None, place: PlaceFn | None = None
) -> Callable[[ApplyFn], ApplyFn]:
    """Decorator registering `apply` (and optional `init` and `place`)
    under `name`."""

    def deco(apply_fn: ApplyFn) -> ApplyFn:
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        _REGISTRY[name] = Op(
            name=name,
            init=init if init is not None else _no_params,
            apply=apply_fn,
            place=place if place is not None else _as_stored,
        )
        return apply_fn

    return deco


def _no_params(gen, attrs, in_shapes, param_dtype) -> NodeParams:
    del gen, attrs, in_shapes, param_dtype
    return {}


def _as_stored(params, attrs, compute_dtype) -> NodeParams:
    del attrs, compute_dtype
    return params


def get_op(name: str) -> Op:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def op_names() -> list[str]:
    return sorted(_REGISTRY)
