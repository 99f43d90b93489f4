"""Weight transplant: external checkpoints -> the port's params, and
speculation drafts carved out of a decoder.

Counterpart of `defer_tpu/models/transplant.py` (`tensor_to_numpy`,
`_from_torch`, the weight sources, `transplant`, `export_keras_weights`,
`load_keras_h5`, `draft_width_geometry` and `make_draft`). `transplant`
walks a graph, asks a `WeightSource` for each parameter, converts the source's layout to the port's (the JAX
package's: NHWC activations, HWIO conv kernels), shape-checks, and
returns a fresh params tree on each parameter's device. Two sources:

  * `KerasWeights`: `{layer_name: [arrays in get_weights() order]}`;
  * `TorchStateDict`: a torch `state_dict` (OIHW conv kernels, (out, in)
    linears, BN running stats) with a node-name -> module-prefix map.

`load_keras_h5` reads that dict out of a Keras `save_weights` HDF5 file
(the classic TF2-era layout and Keras 3's `.weights.h5`), importing
`h5py` only when called: the port does not depend on it.
`export_keras_weights` writes params back in Keras layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class TransplantError(ValueError):
    pass


# Keras get_weights() ordering per op kind.
_KERAS_ORDER: dict[str, tuple[str, ...]] = {
    "conv": ("kernel", "bias"),
    "depthwise_conv": ("kernel", "bias"),
    "separable_conv": ("dw_kernel", "pw_kernel", "bias"),
    "dense": ("kernel", "bias"),
    "batch_norm": ("scale", "bias", "mean", "var"),
    "normalization": ("mean", "var", "count"),
}

_TORCH_KEYS: dict[str, dict[str, str]] = {
    "conv": {"kernel": "weight", "bias": "bias"},
    "depthwise_conv": {"kernel": "weight", "bias": "bias"},
    "dense": {"kernel": "weight", "bias": "bias"},
    "batch_norm": {
        "scale": "weight",
        "bias": "bias",
        "mean": "running_mean",
        "var": "running_var",
    },
    "layer_norm": {"scale": "weight", "bias": "bias"},
    "embedding": {"table": "weight"},
    "pos_embedding": {"table": "weight"},
}


def _from_keras(op: str, param: str, value: np.ndarray) -> np.ndarray:
    if (op, param) in (("separable_conv", "dw_kernel"),
                       ("depthwise_conv", "kernel")):
        # (kh, kw, cin, mult) -> (kh, kw, 1, cin*mult): output channel
        # c*mult + m, the grouped convolution's order.
        kh, kw = value.shape[:2]
        return value.reshape(kh, kw, 1, -1)
    return value


def _to_keras(op: str, param: str, value: np.ndarray, attrs) -> np.ndarray:
    if op == "separable_conv" and param == "dw_kernel":
        kh, kw, _, cm = value.shape
        mult = int(attrs.get("depth_multiplier", 1))
        return value.reshape(kh, kw, cm // mult, mult)
    if op == "depthwise_conv" and param == "kernel":
        kh, kw, _, cm = value.shape
        mult = int(attrs.get("depth_multiplier", 1))
        return value.reshape(kh, kw, cm // mult, mult)
    return value


def tensor_to_numpy(value: Any) -> np.ndarray:
    """Coerce a checkpoint tensor (a torch.Tensor, bfloat16 included,
    which `.numpy()` rejects, or anything array-like) to numpy."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()  # numpy has no bfloat16: widen exactly
        return value.numpy()
    return np.asarray(value)


def _from_torch(op: str, param: str, value: np.ndarray) -> np.ndarray:
    if param == "kernel":
        if op in ("conv", "depthwise_conv"):
            # OIHW (or (cin*mult, 1, kh, kw)) -> HWIO.
            return np.transpose(value, (2, 3, 1, 0))
        if op == "dense":
            return np.transpose(value, (1, 0))  # (out, in) -> (in, out)
    return value


class WeightSource:
    """Protocol: yield converted arrays for a node, or None to skip."""

    def get(self, node, param: str, shape: tuple[int, ...]):
        raise NotImplementedError

    def keys_used(self) -> set[str]:
        raise NotImplementedError

    def all_keys(self) -> set[str]:
        raise NotImplementedError


@dataclasses.dataclass
class KerasWeights(WeightSource):
    """Keras-style `{layer_name: [arrays in get_weights() order]}`.
    `name_map` translates node names to layer names (identity: the
    zoo's names are Keras-shaped). `bn_missing` names the BN param a
    three-array BatchNormalization list lacks (gamma for scale=False,
    beta for center=False)."""

    weights: Mapping[str, Sequence[np.ndarray]]
    name_map: Callable[[str], str] = staticmethod(lambda n: n)
    bn_missing: str = "scale"

    def __post_init__(self) -> None:
        self._used: set[str] = set()
        if self.bn_missing not in ("scale", "bias"):
            raise TransplantError(
                f"bn_missing must be 'scale' or 'bias', got "
                f"{self.bn_missing!r}"
            )

    def _present(self, op: str, n_arrays: int) -> tuple[str, ...]:
        order = _KERAS_ORDER[op]
        if op == "batch_norm" and n_arrays < 4:
            if n_arrays == 2:
                return ("mean", "var")
            if n_arrays == 3:
                return tuple(p for p in order if p != self.bn_missing)
        return order[:n_arrays]  # others only drop a trailing bias

    def get(self, node, param: str, shape):
        key = self.name_map(node.name)
        if key not in self.weights:
            return None
        order = _KERAS_ORDER.get(node.op)
        if order is None or param not in order:
            raise TransplantError(
                f"no Keras layout rule for op {node.op!r} param "
                f"{param!r} (node {node.name!r})"
            )
        arrays = list(self.weights[key])
        present = self._present(node.op, len(arrays))
        if param not in present:
            return None
        self._used.add(key)
        return _from_keras(
            node.op, param, np.asarray(arrays[present.index(param)])
        )

    def keys_used(self) -> set[str]:
        return self._used

    def all_keys(self) -> set[str]:
        return set(self.weights)


@dataclasses.dataclass
class TorchStateDict(WeightSource):
    """A torch `state_dict` source: `name_map` translates a node name
    to its module prefix; the parameter suffix (weight, bias,
    running_mean, ...) follows from the op kind."""

    state_dict: Mapping[str, Any]
    name_map: Callable[[str], str] = staticmethod(lambda n: n)

    def __post_init__(self) -> None:
        self._used: set[str] = set()

    def get(self, node, param: str, shape):
        keys = _TORCH_KEYS.get(node.op)
        if keys is None or param not in keys:
            return None
        key = f"{self.name_map(node.name)}.{keys[param]}"
        if key not in self.state_dict:
            return None
        self._used.add(key)
        return _from_torch(node.op, param,
                           tensor_to_numpy(self.state_dict[key]))

    def keys_used(self) -> set[str]:
        return self._used

    def all_keys(self) -> set[str]:
        return {
            k for k in self.state_dict
            if not k.endswith(".num_batches_tracked")
        }


def transplant(
    graph,
    params: Mapping[str, Mapping[str, torch.Tensor]],
    source: WeightSource,
    *,
    strict: bool = True,
    dtype: Any = None,
) -> dict:
    """A copy of `params` with every array the source provides, each on
    its parameter's device in `dtype` (the parameter's own when None).
    strict=True raises if a parameterized node gets nothing."""
    out: dict = {}
    missing: list[str] = []
    for node in graph.nodes:
        node_params = params.get(node.name, {})
        if not node_params:
            out[node.name] = node_params
            continue
        loaded = {}
        got_any = False
        for pname, cur in node_params.items():
            value = source.get(node, pname, tuple(cur.shape))
            if value is None:
                loaded[pname] = cur
                continue
            if tuple(value.shape) != tuple(cur.shape):
                raise TransplantError(
                    f"shape mismatch for {node.name}.{pname}: checkpoint "
                    f"{tuple(value.shape)} vs model {tuple(cur.shape)}"
                )
            loaded[pname] = torch.as_tensor(
                np.ascontiguousarray(value), dtype=dtype or cur.dtype,
                device=cur.device,
            )
            got_any = True
        if not got_any:
            missing.append(node.name)
        out[node.name] = loaded
    if strict and missing:
        raise TransplantError(
            f"source provided no weights for {len(missing)} parameterized "
            f"nodes, e.g. {missing[:5]}; pass strict=False to keep their "
            "initialized values"
        )
    unused = source.all_keys() - source.keys_used()
    if unused:
        log.warning(
            "transplant: %d checkpoint keys unused, e.g. %s",
            len(unused), sorted(unused)[:5],
        )
    return out


def export_keras_weights(
    graph, params: Mapping[str, Mapping[str, torch.Tensor]]
) -> dict[str, list[np.ndarray]]:
    """Params -> Keras-layout `{layer: [numpy arrays]}` on the host
    (round-trippable through KerasWeights, and loadable into a
    same-architecture Keras model via `set_weights`)."""
    out: dict[str, list[np.ndarray]] = {}
    node_map = graph.node_map
    for name, node_params in params.items():
        if not node_params:
            continue
        node = node_map[name]
        order = _KERAS_ORDER.get(node.op)
        if order is None:
            raise TransplantError(
                f"no Keras layout rule for op {node.op!r} (node {name!r})"
            )
        out[name] = [
            _to_keras(node.op, p, tensor_to_numpy(node_params[p]),
                      node.attrs)
            for p in order
            if p in node_params
        ]
    return out


def _to_snake_case(name: str) -> str:
    """Keras's class-name -> object-name rule (Conv2D -> conv2d,
    BatchNormalization -> batch_normalization, ReLU -> re_lu)."""
    import re

    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def _keras3_group_names(model_json) -> dict[str, str]:
    """h5 group name -> real layer name for a Keras 3 `.weights.h5`.

    Keras 3 names each layer's h5 group by snake-cased class name with
    a per-class counter in model.layers order (NOT by `layer.name`);
    the model JSON's config.layers order reproduces that assignment.
    """
    import json as _json

    spec = (
        _json.loads(model_json) if isinstance(model_json, str) else model_json
    )
    layers = spec.get("config", {}).get("layers", [])
    counters: dict[str, int] = {}
    mapping: dict[str, str] = {}
    for layer in layers:
        cls = layer.get("class_name", "")
        name = layer.get("name") or layer.get("config", {}).get("name")
        base = _to_snake_case(cls)
        idx = counters.get(base, 0)
        counters[base] = idx + 1
        mapping[base if idx == 0 else f"{base}_{idx}"] = name
    return mapping


def load_keras_h5(
    path: str, model_json=None
) -> dict[str, list[np.ndarray]]:
    """Read a Keras `save_weights` HDF5 file into `{layer: [arrays]}`.

    Supports both on-disk layouts: the classic topological layout
    (`layer_names` / `weight_names` attrs) that TF1/2-era Keras writes, and the Keras 3 `.weights.h5`
    layout (`layers/<object_name>/vars/<i>` datasets in
    `layer.weights` order, which matches `get_weights()` ordering).
    Keras 3 group names are per-class counters, not layer names; pass
    the model's `to_json()` string as `model_json` to resolve them to
    real layer names (otherwise the raw object names are returned).
    Needs `h5py`, imported here: the port does not depend on it.
    """
    import h5py

    out: dict[str, list[np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        if "layers" in f and "layer_names" not in f.attrs:
            # Keras 3 layout.
            resolve = (
                _keras3_group_names(model_json) if model_json is not None
                else {}
            )
            layers_group = f["layers"]
            for lname in layers_group:
                g = layers_group[lname]
                if "vars" not in g:
                    continue
                vars_group = g["vars"]
                arrays = [
                    np.asarray(vars_group[k])
                    for k in sorted(vars_group, key=int)
                ]
                if arrays:
                    out[resolve.get(lname, lname)] = arrays
            return out
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in root.attrs.get("layer_names", list(root.keys()))
        ]
        for lname in layer_names:
            g = root[lname]
            weight_names = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs.get("weight_names", [])
            ]
            arrays = [np.asarray(g[w]) for w in weight_names]
            if arrays:
                out[lname] = arrays
    return out


# Per-axis slice spec of each stacked-block parameter (after the leading
# layer axis): "d" model width, "f" FFN width, "kv" the KV projection
# width (kv_heads * Dh, never sliced: the draft keeps the target's
# kv_heads so its proposals come from the verifier's geometry).
_DRAFT_STACK_AXES: dict[str, tuple[str, ...]] = {
    "wq": ("d", "d"),
    "wk": ("d", "kv"),
    "wv": ("d", "kv"),
    "wo": ("d", "d"),
    "w1": ("d", "f"),
    "w2": ("f", "d"),
    "w3": ("d", "f"),
    "ln1_scale": ("d",),
    "ln2_scale": ("d",),
    "ln1_bias": ("d",),
    "ln2_bias": ("d",),
    "bq": ("d",),
    "bk": ("kv",),
    "bv": ("kv",),
    "bo": ("d",),
    "b1": ("f",),
    "b2": ("d",),
}


def draft_width_geometry(cfg, width: float) -> tuple[int, int, int]:
    """(num_heads', dim', ffn_dim') for a width-pruned draft of `cfg`:
    the head count rounds to the nearest multiple of kv_heads (at
    least one), Dh is kept (so rotary frequencies and per-head shapes
    match the target), and the FFN width scales (at least 1)."""
    if not (0.0 < width <= 1.0):
        raise TransplantError(
            f"width={width}: draft width fraction must be in (0, 1]"
        )
    kv = cfg.kv_heads
    dh = cfg.dim // cfg.num_heads
    heads = kv * max(1, round(cfg.num_heads * width / kv))
    heads = min(heads, cfg.num_heads)
    ffn = max(1, round(cfg.ffn_dim * width))
    return heads, heads * dh, ffn


def make_draft(
    decoder,
    params: Mapping[str, Any],
    *,
    layers: int | None = None,
    width: float | None = None,
    dtype: Any = None,
):
    """Carve a speculation draft out of a GPT target: returns
    `(draft_decoder, draft_params)`, the target with its first `layers`
    blocks (layer truncation) and/or its query heads and FFN pruned to a
    `width` fraction. Vocab, kv_heads, head dim, positions and max_len
    are kept: the geometry `DraftLanes` checks against the target.

    The slices are views of the target's tensors (no copy) unless
    `dtype` asks for a cast; `dtype="int8"` routes the sliced tree
    through `models/quant.py::quantize_decoder_params`."""
    from defer_tpu_torch.models.gpt import GptDecoder
    from defer_tpu_torch.models.quant import quantize_decoder_params

    cfg = getattr(decoder, "cfg", None)
    if cfg is None or "stack" not in params:
        raise TransplantError(
            "make_draft needs a GptDecoder-style (decoder, params) pair "
            "(a .cfg config and a params['stack'] block tree)"
        )
    if any(
        isinstance(v, dict) and "q" in v
        for v in list(params["stack"].values())
        + [params.get("token_embedding")]
        if v is not None
    ):
        raise TransplantError(
            "make_draft slices float params: quantized {'q','s'} leaves "
            "would lose their per-channel scales; build the draft from "
            "the float tree, then ask for dtype='int8'"
        )
    L = cfg.num_layers
    keep_l = L if layers is None else layers
    if not (1 <= keep_l <= L):
        raise TransplantError(
            f"layers={layers}: draft must keep between 1 and "
            f"{L} (the target's depth) blocks"
        )
    if width is None:
        heads, dim, ffn = cfg.num_heads, cfg.dim, cfg.ffn_dim
    else:
        heads, dim, ffn = draft_width_geometry(cfg, width)
    dims = {"d": dim, "f": ffn,
            "kv": cfg.kv_heads * (cfg.dim // cfg.num_heads)}

    stack = {}
    for k, v in params["stack"].items():
        if k not in _DRAFT_STACK_AXES:
            raise TransplantError(
                f"stack param {k!r} has no draft slice rule: drafts "
                "support plain GPT/llama decoder stacks (no MoE, no "
                "LoRA adapters; merge adapters first)"
            )
        idx = (slice(0, keep_l),) + tuple(
            slice(0, dims[a]) for a in _DRAFT_STACK_AXES[k]
        )
        stack[k] = v[idx]
    out: dict[str, Any] = {"stack": stack}
    out["token_embedding"] = params["token_embedding"][:, :dim]
    out["final_ln_scale"] = params["final_ln_scale"][:dim]
    if "final_ln_bias" in params:
        out["final_ln_bias"] = params["final_ln_bias"][:dim]
    if "pos_embedding" in params:
        out["pos_embedding"] = params["pos_embedding"][:, :dim]
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"][:dim, :]

    dcfg = dataclasses.replace(
        cfg, num_layers=keep_l, num_heads=heads, num_kv_heads=cfg.kv_heads,
        dim=dim, ffn_dim=ffn,
    )
    draft = GptDecoder(dcfg, compute_dtype=decoder.compute_dtype,
                       device=decoder.device)
    if dtype == "int8":
        out = quantize_decoder_params(out)
    elif dtype is not None:

        def cast(a):
            if isinstance(a, dict):
                return {k: cast(v) for k, v in a.items()}
            return a.to(dtype) if a.is_floating_point() else a

        out = cast(out)
    log.info(
        "draft: %d/%d layers, %d/%d heads, dim %d/%d, ffn %d/%d%s",
        keep_l, L, heads, cfg.num_heads, dim, cfg.dim, ffn, cfg.ffn_dim,
        " (int8)" if dtype == "int8" else "",
    )
    return draft, out
