"""Model zoo on the graph IR (counterpart of `defer_tpu/models`).

Each model is built natively as an IR graph with the JAX package's node
names, so the same cut lists apply unchanged and param trees map 1:1.

Registry:
    model = get_model("bert_base")       # -> Model(graph, input_shape, ...)
    params = model.init(torch.Generator().manual_seed(0))
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from defer_tpu_torch.graph.ir import Graph, GraphParams


@dataclasses.dataclass(frozen=True)
class Model:
    """A zoo model: IR graph + input spec + recommended cut points.

    `default_cuts(n)` returns n-1 cut points giving n roughly balanced
    stages.
    """

    name: str
    graph: Graph
    input_shape: tuple[int, ...]  # without batch dim
    input_dtype: Any = torch.float32
    # Each candidate is one boundary: a node name, or a tuple of names
    # for a multi-tensor bundle.
    cut_candidates: tuple[str | tuple[str, ...], ...] = ()

    def init(
        self,
        generator: torch.Generator,
        *,
        batch_size: int = 1,
        param_dtype: Any = torch.float32,
    ) -> GraphParams:
        """Random params drawn from `generator`, on its device."""
        return self.graph.init(
            generator,
            (batch_size, *self.input_shape),
            param_dtype=param_dtype,
            input_dtype=self.input_dtype,
        )

    def example_input(
        self, batch_size: int = 1, dtype: Any | None = None
    ) -> torch.Tensor:
        """Zeros (integer inputs) or ones, on the CPU."""
        dtype = dtype or self.input_dtype
        shape = (batch_size, *self.input_shape)
        if not dtype.is_floating_point:
            return torch.zeros(shape, dtype=dtype)
        return torch.ones(shape, dtype=dtype)

    def default_cuts(self, num_stages: int) -> list[str | tuple[str, ...]]:
        if num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        if num_stages == 1:
            return []
        cands = self.cut_candidates
        if num_stages - 1 > len(cands):
            raise ValueError(
                f"{self.name} has {len(cands)} candidate cut points; "
                f"cannot make {num_stages} stages"
            )
        # Evenly spaced picks, kept strictly increasing so we always
        # return exactly num_stages-1 distinct cuts.
        picks: list[int] = []
        prev = -1
        remaining = num_stages - 1
        for i in range(num_stages - 1):
            j = round((i + 1) * len(cands) / num_stages) - 1
            j = max(j, prev + 1)
            j = min(j, len(cands) - (remaining - i))
            picks.append(j)
            prev = j
        return [cands[j] for j in picks]


_BUILDERS: dict[str, Callable[..., Model]] = {}


def register_model(name: str) -> Callable:
    def deco(fn: Callable[..., Model]) -> Callable[..., Model]:
        _BUILDERS[name] = fn
        return fn

    return deco


def _load_zoo() -> None:
    """Import every ported zoo module for its register_model side
    effects."""
    import importlib

    for mod in ("bert",):
        importlib.import_module(f"defer_tpu_torch.models.{mod}")


def get_model(name: str, **kwargs: Any) -> Model:
    _load_zoo()
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_BUILDERS)}"
        ) from None
    return builder(**kwargs)


def model_names() -> list[str]:
    _load_zoo()
    return sorted(_BUILDERS)
