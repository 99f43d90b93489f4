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


@dataclasses.dataclass(frozen=True)
class Op:
    """An op kind.

    init(generator, attrs, in_shapes, param_dtype) -> params dict (maybe
      empty), drawn from `generator` on the generator's device
    apply(params, inputs, attrs) -> output tensor
    """

    name: str
    init: InitFn
    apply: ApplyFn


_REGISTRY: dict[str, Op] = {}


def register_op(
    name: str, *, init: InitFn | None = None
) -> Callable[[ApplyFn], ApplyFn]:
    """Decorator registering `apply` (and optional `init`) under `name`."""

    def deco(apply_fn: ApplyFn) -> ApplyFn:
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        _REGISTRY[name] = Op(
            name=name, init=init if init is not None else _no_params, apply=apply_fn
        )
        return apply_fn

    return deco


def _no_params(gen, attrs, in_shapes, param_dtype) -> NodeParams:
    del gen, attrs, in_shapes, param_dtype
    return {}


def get_op(name: str) -> Op:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def op_names() -> list[str]:
    return sorted(_REGISTRY)
