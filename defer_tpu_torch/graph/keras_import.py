"""Keras `model.to_json()` ingester -> IR Graph (counterpart of
`defer_tpu/graph/keras_import.py`: the same nodes, names and attrs).

The reference's wire format for model architectures IS Keras JSON: the
dispatcher ships `model.to_json()` strings (reference
src/dispatcher.py:52) and nodes rebuild with `model_from_json`
(reference src/node.py:38). This module is the compatibility path for
that ecosystem: a user bringing a serialized Keras model gets an IR
Graph that partitions/pipelines like any zoo model, on random init or
on the weights of its `save_weights` h5 file (`model_from_keras(...,
weights_h5=)`, through `models/transplant.py`'s `load_keras_h5`, which
imports `h5py` when called).

Supports both JSON dialects: the classic functional layout
(`config.layers` with `inbound_nodes` as
`[[[layer, node_idx, tensor_idx, kwargs]...]]`) that TF1-era Keras —
the reference's environment (reference src/node.py:19-20) — emits, and
the Keras 3 layout (`inbound_nodes` as `[{"args": ..., "kwargs": ...}]`
with `__keras_tensor__`/`keras_history` entries, `batch_shape` inputs,
flat single-io `input_layers`) that current `tf.keras` emits.
Restricted to single-input single-output graphs (the same restriction
the reference's partitioner has, reference src/dag_util.py:29-33).

Layers with fused activations (e.g. Conv2D(activation='relu')) expand
to two IR nodes; the activation node is named `<layer>_activation_fused`
and downstream edges re-point to it, while the parameterized node keeps
the layer name so a weights transplant's identity name map finds its
arrays.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping

from defer_tpu_torch.graph.ir import Graph, GraphBuilder


class KerasImportError(ValueError):
    pass


def _pad_attr(cfg: Mapping[str, Any]) -> str:
    return str(cfg.get("padding", "valid")).upper()


_ACTIVATIONS = {
    "relu": "relu",
    "relu6": "relu6",
    "sigmoid": "sigmoid",
    "tanh": "tanh",
    "swish": "swish",
    "silu": "swish",
    "gelu": "gelu",
    "softmax": "softmax",
    "linear": None,
}


def _activation_op(name: str) -> str | None:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(
            f"unsupported Keras activation {name!r}; supported: "
            f"{sorted(k for k in _ACTIVATIONS)}"
        ) from None


# Each handler: (builder, name, config, inputs) -> output node name.
_HANDLERS: dict[str, Callable] = {}


def _handler(*class_names: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        for cn in class_names:
            _HANDLERS[cn] = fn
        return fn

    return deco


def _fused_activation(b: GraphBuilder, x: str, name: str, cfg) -> str:
    act = cfg.get("activation")
    if act in (None, "linear"):
        return x
    op = _activation_op(act)
    return b.add(op, x, name=f"{name}_activation_fused")


@_handler("Conv2D")
def _conv(b: GraphBuilder, name: str, cfg, inputs):
    x = b.add(
        "conv",
        inputs[0],
        name=name,
        features=int(cfg["filters"]),
        kernel_size=tuple(cfg["kernel_size"]),
        strides=tuple(cfg.get("strides", (1, 1))),
        padding=_pad_attr(cfg),
        dilation=tuple(cfg.get("dilation_rate", (1, 1))),
        groups=int(cfg.get("groups", 1)),
        use_bias=bool(cfg.get("use_bias", True)),
    )
    return _fused_activation(b, x, name, cfg)


@_handler("DepthwiseConv2D")
def _depthwise(b: GraphBuilder, name: str, cfg, inputs):
    x = b.add(
        "depthwise_conv",
        inputs[0],
        name=name,
        kernel_size=tuple(cfg["kernel_size"]),
        strides=tuple(cfg.get("strides", (1, 1))),
        padding=_pad_attr(cfg),
        dilation=tuple(cfg.get("dilation_rate", (1, 1))),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        use_bias=bool(cfg.get("use_bias", True)),
    )
    return _fused_activation(b, x, name, cfg)


@_handler("SeparableConv2D")
def _separable(b: GraphBuilder, name: str, cfg, inputs):
    x = b.add(
        "separable_conv",
        inputs[0],
        name=name,
        features=int(cfg["filters"]),
        kernel_size=tuple(cfg["kernel_size"]),
        strides=tuple(cfg.get("strides", (1, 1))),
        padding=_pad_attr(cfg),
        dilation=tuple(cfg.get("dilation_rate", (1, 1))),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        use_bias=bool(cfg.get("use_bias", True)),
    )
    return _fused_activation(b, x, name, cfg)


@_handler("Dense")
def _dense(b: GraphBuilder, name: str, cfg, inputs):
    x = b.add(
        "dense",
        inputs[0],
        name=name,
        features=int(cfg["units"]),
        use_bias=bool(cfg.get("use_bias", True)),
    )
    return _fused_activation(b, x, name, cfg)


@_handler("BatchNormalization")
def _bn(b: GraphBuilder, name: str, cfg, inputs):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0]
    if axis not in (-1, 3):
        raise KerasImportError(
            f"BatchNormalization {name!r}: only channels-last (axis=-1/3) "
            f"is supported, got axis={axis}"
        )
    return b.add(
        "batch_norm", inputs[0], name=name, eps=float(cfg.get("epsilon", 1e-3))
    )


@_handler("Activation")
def _activation(b: GraphBuilder, name: str, cfg, inputs):
    op = _activation_op(cfg["activation"])
    if op is None:
        return b.add("identity", inputs[0], name=name)
    return b.add(op, inputs[0], name=name)


@_handler("ReLU")
def _relu_layer(b: GraphBuilder, name: str, cfg, inputs):
    slope = float(cfg.get("negative_slope") or 0.0)
    threshold = float(cfg.get("threshold") or 0.0)
    if slope != 0.0 or threshold != 0.0:
        raise KerasImportError(
            f"ReLU {name!r}: negative_slope/threshold variants are not "
            f"supported (got slope={slope}, threshold={threshold})"
        )
    mv = cfg.get("max_value")
    if mv is not None and float(mv) == 6.0:
        return b.add("relu6", inputs[0], name=name)
    if mv is not None:
        raise KerasImportError(f"ReLU {name!r}: unsupported max_value {mv}")
    return b.add("relu", inputs[0], name=name)


@_handler("Softmax")
def _softmax_layer(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("softmax", inputs[0], name=name, axis=int(cfg.get("axis", -1)))


@_handler("MaxPooling2D")
def _max_pool(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "max_pool",
        inputs[0],
        name=name,
        window=tuple(cfg.get("pool_size", (2, 2))),
        strides=tuple(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
        padding=_pad_attr(cfg),
    )


@_handler("AveragePooling2D")
def _avg_pool(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "avg_pool",
        inputs[0],
        name=name,
        window=tuple(cfg.get("pool_size", (2, 2))),
        strides=tuple(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
        padding=_pad_attr(cfg),
    )


@_handler("GlobalAveragePooling2D")
def _gap(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "global_avg_pool", inputs[0], name=name,
        keepdims=bool(cfg.get("keepdims", False)),
    )


@_handler("GlobalMaxPooling2D")
def _gmp(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "global_max_pool", inputs[0], name=name,
        keepdims=bool(cfg.get("keepdims", False)),
    )


@_handler("ZeroPadding2D")
def _zero_pad(b: GraphBuilder, name: str, cfg, inputs):
    pad = cfg["padding"]
    if isinstance(pad, int):
        pad = ((pad, pad), (pad, pad))
    else:
        pad = tuple(
            (p, p) if isinstance(p, int) else tuple(p) for p in pad
        )
    return b.add("zero_pad", inputs[0], name=name, padding=pad)


@_handler("Cropping2D")
def _crop(b: GraphBuilder, name: str, cfg, inputs):
    crop = cfg["cropping"]
    if isinstance(crop, int):
        crop = ((crop, crop), (crop, crop))
    else:
        crop = tuple(
            (c, c) if isinstance(c, int) else tuple(c) for c in crop
        )
    return b.add("crop", inputs[0], name=name, cropping=crop)


@_handler("Flatten")
def _flatten(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("flatten", inputs[0], name=name)


@_handler("Reshape")
def _reshape(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "reshape", inputs[0], name=name, shape=tuple(cfg["target_shape"])
    )


@_handler("Dropout", "SpatialDropout2D", "GaussianDropout")
def _dropout(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("dropout", inputs[0], name=name)


@_handler("Rescaling")
def _rescaling(b: GraphBuilder, name: str, cfg, inputs):
    return b.add(
        "rescale",
        inputs[0],
        name=name,
        scale=float(cfg.get("scale", 1.0)),
        offset=float(cfg.get("offset", 0.0)),
    )


@_handler("Normalization")
def _normalization(b: GraphBuilder, name: str, cfg, inputs):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0] if len(axis) == 1 else axis
    if axis not in (-1, 3):
        raise KerasImportError(
            f"Normalization {name!r}: only channels-last (axis=-1/3) is "
            f"supported, got axis={axis}"
        )
    if cfg.get("invert"):
        raise KerasImportError(
            f"Normalization {name!r}: invert=True is not supported"
        )
    attrs = {}
    if cfg.get("mean") is not None:
        attrs = {"mean": cfg["mean"], "variance": cfg["variance"]}
    return b.add("normalization", inputs[0], name=name, **attrs)


@_handler("Add")
def _add(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("add", *inputs, name=name)


@_handler("CustomScaleLayer")
def _custom_scale(b: GraphBuilder, name: str, cfg, inputs):
    """Keras applications' InceptionResNetV2 residual scaling:
    inputs[0] + inputs[1] * scale."""
    if len(inputs) != 2:
        raise KerasImportError(
            f"CustomScaleLayer {name!r} expects 2 inputs, got {len(inputs)}"
        )
    scaled = b.add(
        "scale",
        inputs[1],
        name=f"{name}_scaled",
        value=float(cfg.get("scale", 1.0)),
    )
    return b.add("add", inputs[0], scaled, name=name)


@_handler("Multiply")
def _multiply(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("multiply", *inputs, name=name)


@_handler("Concatenate")
def _concat(b: GraphBuilder, name: str, cfg, inputs):
    return b.add("concat", *inputs, name=name, axis=int(cfg.get("axis", -1)))


def supported_layers() -> list[str]:
    return sorted(_HANDLERS)


def _check_history(name: str, node_idx: int, tensor_idx: int) -> str:
    if node_idx != 0 or tensor_idx != 0:
        raise KerasImportError(
            f"non-trivial inbound node ({name}, {node_idx}, "
            f"{tensor_idx}) is not supported"
        )
    return name


def _collect_keras3_tensors(obj: Any, names: list[str]) -> None:
    """Depth-first collect `__keras_tensor__` histories from a Keras 3
    node-args structure (tensors may be nested in lists, e.g. Add/
    Concatenate take a list of tensors as one positional arg)."""
    if isinstance(obj, Mapping):
        if obj.get("class_name") == "__keras_tensor__":
            hist = obj.get("config", {}).get("keras_history")
            if not hist or len(hist) < 3:
                raise KerasImportError(
                    f"__keras_tensor__ lacks keras_history: {obj!r}"
                )
            names.append(_check_history(hist[0], hist[1], hist[2]))
        else:
            for v in obj.values():
                _collect_keras3_tensors(v, names)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_keras3_tensors(v, names)


def _inbound_names(inbound_nodes: Any) -> list[str]:
    """Extract producer layer names from inbound_nodes JSON.

    Two dialects: classic TF1-era
    `[[[layer_name, node_index, tensor_index, kwargs], ...]]` (the
    reference's environment, reference src/node.py:19-20) and Keras 3
    `[{"args": [...], "kwargs": {...}}]` where tensors appear as
    `__keras_tensor__` dicts carrying `keras_history`. One inbound node
    only — shared layers called multiple times are out of scope, as in
    the reference."""
    if not inbound_nodes:
        return []
    if len(inbound_nodes) != 1:
        raise KerasImportError(
            "shared layers (multiple inbound nodes) are not supported"
        )
    node = inbound_nodes[0]
    names: list[str] = []
    if isinstance(node, Mapping):  # Keras 3 dialect
        _collect_keras3_tensors(node.get("args", []), names)
        if not names:
            raise KerasImportError(
                f"Keras 3 inbound node has no tensor args: {node!r}"
            )
        return names
    for entry in node:
        names.append(_check_history(entry[0], entry[1], entry[2]))
    return names


def _io_layer_name(specs: Any, which: str) -> str:
    """Single input/output layer name from `input_layers` /
    `output_layers`, accepting classic `[["name", 0, 0]]` and Keras 3
    flat `["name", 0, 0]` forms."""
    if not isinstance(specs, (list, tuple)) or not specs:
        raise KerasImportError(f"model JSON lacks {which}")
    if isinstance(specs[0], str):  # Keras 3 single-io flat form
        entry = specs
    elif len(specs) != 1:
        raise KerasImportError(
            "only single-input single-output models are supported (the "
            "reference has the same restriction)"
        )
    else:
        entry = specs[0]
    if not isinstance(entry, (list, tuple)) or len(entry) < 3:
        raise KerasImportError(f"malformed {which} entry: {entry!r}")
    return _check_history(entry[0], entry[1], entry[2])


def _sequential_to_functional(spec: Mapping[str, Any]) -> dict:
    """Rewrite a Sequential model JSON as the functional layout: each
    layer's inbound node is simply the previous layer."""
    cfg = spec.get("config")
    layers = cfg.get("layers") if isinstance(cfg, Mapping) else cfg
    if not isinstance(layers, (list, tuple)):
        raise KerasImportError(
            "Sequential JSON has no config.layers list; expected the "
            "functional layout or a Sequential config with layers, got "
            f"config={cfg!r}"
        )
    out_layers = []
    prev: str | None = None
    for layer in layers:
        if not isinstance(layer, Mapping) or "class_name" not in layer:
            raise KerasImportError(
                f"malformed Sequential layer entry (need a mapping with "
                f"class_name/config): {layer!r}"
            )
        layer = dict(layer)
        layer_cfg = layer.get("config")
        if not isinstance(layer_cfg, Mapping):
            raise KerasImportError(
                f"Sequential layer {layer.get('name', layer['class_name'])!r} "
                f"has no config mapping"
            )
        name = layer.get("name") or layer_cfg.get("name")
        if layer["class_name"] == "InputLayer":
            prev = name
            layer.setdefault("inbound_nodes", [])
            out_layers.append(layer)
            continue
        if prev is None:
            # Sequential without an explicit InputLayer: the first real
            # layer carries batch_input_shape (classic) or the config
            # has build_input_shape (Keras 3); synthesize the input.
            shape = (
                layer_cfg.get("batch_input_shape")
                or layer_cfg.get("batch_shape")
                or (cfg.get("build_input_shape")
                    if isinstance(cfg, Mapping) else None)
            )
            if shape is None:
                raise KerasImportError(
                    "Sequential JSON lacks an InputLayer and the first "
                    "layer has no batch_input_shape"
                )
            out_layers.append(
                {
                    "class_name": "InputLayer",
                    "name": "seq_input",
                    "config": {
                        "name": "seq_input",
                        "batch_input_shape": shape,
                    },
                    "inbound_nodes": [],
                }
            )
            prev = "seq_input"
        layer["inbound_nodes"] = [[[prev, 0, 0, {}]]]
        out_layers.append(layer)
        prev = name
    if prev is None:
        raise KerasImportError("Sequential model has no layers")
    return {
        "class_name": "Functional",
        "config": {
            "name": (cfg.get("name", "sequential") if isinstance(cfg, Mapping)
                     else "sequential"),
            "layers": out_layers,
            "input_layers": [[out_layers[0]["name"], 0, 0]],
            "output_layers": [[prev, 0, 0]],
        },
    }


def from_keras_json(text: str | Mapping[str, Any]) -> tuple[Graph, tuple[int, ...]]:
    """Parse a Keras functional-model JSON into (Graph, input_shape).

    input_shape excludes the batch dimension. Raises KerasImportError
    for unsupported layer classes/configs with an explicit message —
    the reference would fail deep inside deserialization instead.
    """
    spec = json.loads(text) if isinstance(text, str) else text
    if spec.get("class_name") == "Sequential":
        spec = _sequential_to_functional(spec)
    if spec.get("class_name") not in ("Functional", "Model"):
        raise KerasImportError(
            f"expected a functional or Sequential model JSON, got class "
            f"{spec.get('class_name')!r}"
        )
    cfg = spec["config"]
    layers = cfg["layers"]

    input_layer = _io_layer_name(cfg.get("input_layers"), "input_layers")
    output_layer = _io_layer_name(cfg.get("output_layers"), "output_layers")

    b = GraphBuilder(cfg.get("name", "keras_model"))
    produced: dict[str, str] = {}  # layer name -> IR node producing its output
    input_shape: tuple[int, ...] | None = None

    for layer in layers:
        cls = layer["class_name"]
        lcfg = layer["config"]
        name = layer.get("name", lcfg.get("name"))
        if cls == "InputLayer":
            if name != input_layer:
                raise KerasImportError(
                    f"unexpected extra InputLayer {name!r}"
                )
            shape = lcfg.get("batch_input_shape") or lcfg.get("batch_shape")
            if shape:
                if any(d is None for d in shape[1:]):
                    raise KerasImportError(
                        f"InputLayer {name!r} has variable dims "
                        f"{shape}: the graph needs static shapes — re-export "
                        "the model with a concrete input size"
                    )
                input_shape = tuple(int(d) for d in shape[1:])
            produced[name] = b.input(name)
            continue
        handler = _HANDLERS.get(cls)
        if handler is None:
            raise KerasImportError(
                f"unsupported Keras layer class {cls!r} (layer {name!r}); "
                f"supported: {supported_layers()}"
            )
        if lcfg.get("data_format") == "channels_first":
            raise KerasImportError(
                f"layer {name!r} uses data_format='channels_first'; only "
                "channels-last models are supported (the graph's layout "
                "is NHWC)"
            )
        srcs = _inbound_names(layer.get("inbound_nodes"))
        if not srcs:
            raise KerasImportError(f"layer {name!r} has no inbound nodes")
        try:
            inputs = [produced[s] for s in srcs]
        except KeyError as e:
            raise KerasImportError(
                f"layer {name!r} consumes undeclared layer {e.args[0]!r}"
            ) from None
        produced[name] = handler(b, name, lcfg, inputs)

    if output_layer not in produced:
        raise KerasImportError(f"output layer {output_layer!r} not found")
    graph = b.build(produced[output_layer])
    if input_shape is None:
        raise KerasImportError("InputLayer lacks batch_input_shape")
    return graph, input_shape


def model_from_keras(
    text: str | Mapping[str, Any],
    *,
    weights_h5: str | None = None,
    params=None,
    generator=None,
    device=None,
):
    """Keras JSON (+ optional h5 weights) -> (Model, params | None).

    The compatibility path: the artifacts a reference user already has
    (a `model.to_json()` string, a `save_weights` h5 file) become a
    zoo-style Model with auto-discovered cut candidates, ready for
    `DEFER().run_defer`. Returns (model, params): `params` passes
    through unless `weights_h5` is given, which loads the file
    (`models/transplant.py` `load_keras_h5`, needing h5py) into the
    model's params: their shapes are drawn first from `generator` (one
    seeded 0 on `device` when None; `device` defaults to the first CUDA
    device and raises without one), and the loaded values land on the
    generator's device."""
    from defer_tpu_torch.graph.partition import chain_boundaries
    from defer_tpu_torch.models import Model

    graph, input_shape = from_keras_json(text)
    model = Model(
        name=graph.name,
        graph=graph,
        input_shape=input_shape,
        # Width-2 discovery keeps single-tensor articulation points as
        # plain names and adds (a, b) bundles where no single tensor
        # separates the chain (NASNet-class imports).
        cut_candidates=tuple(chain_boundaries(graph, max_width=2)),
    )
    loaded = params
    if weights_h5 is not None:
        from defer_tpu_torch.models.transplant import (
            KerasWeights,
            load_keras_h5,
            transplant,
        )

        import torch

        from defer_tpu_torch.parallel.mesh import cuda_devices

        if generator is None:
            dev = device if device is not None else cuda_devices()[0]
            generator = torch.Generator(device=dev).manual_seed(0)
        base = model.init(generator)
        loaded = transplant(
            graph, base, KerasWeights(load_keras_h5(weights_h5, text))
        )
    return model, loaded
