"""The CNN zoo and ViT through both packages: graphs, shapes, cuts, FLOPs,
Keras names and logits; the auto cuts and run_defer on ResNet50.

Each entry is built at a small resolution (its global-pooling head, or
ViT's `image_size`, makes that a change of input size only). Weights
are numpy draws from a fixed seed in the shapes the JAX init gives
(`jax.eval_shape`, nothing is compiled for the init): conv, dense and
attention matrices N(0, 2 / fan_in), norm scales and variances U(0.5,
1.5), the rest N(0, 0.01). The port gets them through
`params_from_jax`. Logits are taken before the output softmax, so a
saturated softmax cannot hide a difference. Everything runs in float32
on the CPU; logits must agree within 1e-4 of their largest magnitude
(the packages sum a hundred-odd layers in different orders).
"""

import dataclasses
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defer_tpu
import defer_tpu.utils.flops as jax_flops
from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch import DEFER, DeferConfig, params_from_jax
from defer_tpu_torch.models import get_model
from defer_tpu_torch.utils import flops

CPU = torch.device("cpu")
LOGIT_RTOL = 1e-4

# name -> (input resolution, batch)
ZOO = {
    "resnet50": (64, 2),
    "resnet101": (64, 1),
    "resnet152": (64, 1),
    "vgg16": (32, 1),
    "vgg19": (32, 1),
    "mobilenetv2": (96, 1),
    "efficientnet_b0": (96, 1),
    "efficientnet_b1": (96, 1),
    "inceptionv3": (96, 1),
    "inception_resnet_v2": (96, 1),
    "xception": (96, 1),
    "densenet121": (64, 1),
    "densenet169": (64, 1),
    "nasnet_mobile": (64, 1),
    "nasnet_large": (64, 1),
    "vit_tiny": (32, 2),
    "vit_s16": (32, 1),
    "vit_b16": (32, 1),
}
# The entries whose logits are compared (the rest: structure only).
LOGITS = ["resnet50", "vgg16", "mobilenetv2", "efficientnet_b0",
          "inceptionv3", "inception_resnet_v2", "xception", "densenet121",
          "nasnet_mobile", "vit_tiny"]


def _build(get, name):
    res, _ = ZOO[name]
    if name.startswith("vit"):
        return get(name, image_size=res)
    return dataclasses.replace(get(name), input_shape=(res, res, 3))


def _weights(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for node, leaves in shapes.items():
        out[node] = {}
        for k, s in leaves.items():
            shape = tuple(s.shape)
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[:-1]))
                a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = rng.standard_normal(shape) * 0.1
            out[node][k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def entry():
    """name -> (jax model, port model, param shapes as the JAX init
    gives them, input shape), built once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            jmodel, model = _build(jax_get_model, name), _build(get_model, name)
            batch = ZOO[name][1]
            shapes = jax.eval_shape(
                lambda k: jmodel.init(k, batch_size=batch), jax.random.key(0)
            )
            cache[name] = (jmodel, model, shapes, (batch, *model.input_shape))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def resnet50(entry):
    """ResNet50 at 64x64, batch 2, with its numpy weights."""
    jmodel, model, shapes, shape = entry("resnet50")
    return jmodel, model, _weights(shapes), shape


def _logits_name(graph):
    out = graph.node_map[graph.output_name]
    return out.inputs[0] if out.op == "softmax" else out.name


@pytest.mark.parametrize("name", list(ZOO))
def test_structure_matches_jax(entry, name, monkeypatch):
    """Nodes (names, ops, inputs, attrs), inferred shapes, cut
    candidates, default cuts, FLOPs, balanced cuts and Keras names."""
    jmodel, model, shapes, shape = entry(name)
    jg, g = jmodel.graph, model.graph
    assert [(n.name, n.op, n.inputs, dict(n.attrs)) for n in g.nodes] == [
        (n.name, n.op, n.inputs, dict(n.attrs)) for n in jg.nodes
    ]
    assert (g.input_name, g.output_name) == (jg.input_name, jg.output_name)
    assert model.cut_candidates == jmodel.cut_candidates
    assert model.input_shape == jmodel.input_shape
    for n in (2, 4, 8):
        if n - 1 > len(model.cut_candidates):
            with pytest.raises(ValueError):
                jmodel.default_cuts(n)
            with pytest.raises(ValueError):
                model.default_cuts(n)
        else:
            assert model.default_cuts(n) == jmodel.default_cuts(n)
    if jmodel.keras_name_map is None:
        assert model.keras_name_map is None
    else:
        assert [model.keras_name_map(n.name) for n in g.nodes] == [
            jmodel.keras_name_map(n.name) for n in jg.nodes
        ]

    # Shapes and FLOPs from params without data: meta tensors in the
    # port, shape structs in the JAX package.
    meta = {
        node: {k: torch.empty(v.shape, device="meta") for k, v in p.items()}
        for node, p in shapes.items()
    }
    jspecs = jg.infer_shapes(shapes, shape)
    specs = g.infer_shapes(meta, shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in jspecs.items()
    }
    per_node = flops.flops_by_node(g, meta, shape)
    jper_node = jax_flops.flops_by_node(jg, shapes, shape, specs=jspecs)
    assert per_node == jper_node
    assert flops.graph_flops(g, meta, shape) == sum(jper_node.values())
    # The JAX package's picks from its own per-node FLOPs (computed
    # once above, instead of once a call).
    monkeypatch.setattr(jax_flops, "flops_by_node", lambda *a, **k: jper_node)
    for n in (2, 4, 8):
        if n - 1 <= len(model.cut_candidates):
            assert flops.balanced_cuts(
                g, meta, shape, n, model.cut_candidates
            ) == jax_flops.balanced_cuts(jg, shapes, shape, n,
                                         jmodel.cut_candidates)


@pytest.mark.parametrize("name", LOGITS)
def test_logits_match_jax(entry, name):
    jmodel, model, shapes, shape = entry(name)
    weights = _weights(shapes)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    logits = _logits_name(jmodel.graph)
    jg = dataclasses.replace(jmodel.graph, output_name=logits)
    g = dataclasses.replace(model.graph, output_name=logits)
    want = np.asarray(jax.jit(jg.apply)(weights, jnp.asarray(x)))
    with torch.inference_mode():
        got = g.apply(params_from_jax(weights, CPU),
                      torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max()
    )


def _run_stream(defer, model, cuts, params, inputs):
    in_q: "queue.Queue" = queue.Queue()
    out_q: "queue.Queue" = queue.Queue()
    t = threading.Thread(
        target=defer.run_defer,
        args=(model, cuts, in_q, out_q),
        kwargs={"params": params},
        daemon=True,
    )
    t.start()
    for x in inputs:
        in_q.put(x)
    in_q.put(None)
    outs = [out_q.get(timeout=120) for _ in inputs]
    t.join(timeout=60)
    assert not t.is_alive()
    assert out_q.empty()
    return outs


@pytest.mark.parametrize(
    "cuts", [["add_8"], "default_cuts(2)"], ids=["add_8", "default_cuts"]
)
def test_resnet50_run_defer_matches_the_whole_graph(resnet50, cuts):
    """A 2-stage CPU run_defer of ResNet50 against the unpartitioned
    graph on the same weights (the stages hold the placement form:
    O,H,W,I kernels, folded batch norms)."""
    _, model, weights, shape = resnet50
    if cuts == "default_cuts(2)":
        cuts = model.default_cuts(2)
    params = params_from_jax(weights, CPU)
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          for _ in range(3)]
    defer = DEFER(devices=[CPU],
                  config=DeferConfig(compute_dtype=torch.float32))
    outs = _run_stream(defer, model, cuts, params, xs)
    assert defer.last_pipeline.num_stages == 2
    for x, out in zip(xs, outs):
        assert out.shape == (shape[0], 1000)
        torch.testing.assert_close(
            out, model.graph.apply(params, x), atol=1e-6, rtol=1e-5
        )


def _stage_inputs(stages):
    return [getattr(s, "input_names", None) or s.input_name
            for s in stages[1:]]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_auto_cuts_match_jax(resnet50, n_dev):
    """partition_layers="auto": one stage per device, the FLOPs-balanced
    picks of the JAX package for the same stage count."""
    jmodel, model, weights, shape = resnet50
    jdefer = defer_tpu.DEFER(
        jax.devices()[:n_dev],
        config=defer_tpu.DeferConfig(compute_dtype=jnp.float32),
    )
    jpipe, _ = jdefer.build_pipeline(jmodel, "auto", params=weights,
                                     batch_size=shape[0])
    defer = DEFER(devices=[CPU] * n_dev,
                  config=DeferConfig(compute_dtype=torch.float32))
    params = params_from_jax(weights, CPU)
    pipe, example = defer.build_pipeline(
        model, "auto", params=params, batch_size=shape[0]
    )
    assert pipe.num_stages == jpipe.num_stages == n_dev
    assert _stage_inputs(pipe.stages) == _stage_inputs(jpipe.stages)
    with torch.inference_mode():
        torch.testing.assert_close(
            pipe(example), model.graph.apply(params, example),
            atol=1e-6, rtol=1e-5,
        )


def test_auto_cuts_on_a_raw_graph_raise_as_in_jax(resnet50):
    jmodel, model, weights, _ = resnet50
    with pytest.raises(ValueError) as jerr:
        defer_tpu.DEFER(jax.devices()[:2]).build_pipeline(
            jmodel.graph, "auto", params=weights
        )
    with pytest.raises(ValueError) as err:
        DEFER(devices=[CPU] * 2).build_pipeline(
            model.graph, "auto", params=params_from_jax(weights, CPU)
        )
    assert str(err.value) == str(jerr.value)


def test_peak_table_is_nvidia_only():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert flops.peak_flops("cpu") is None
    assert flops.peak_flops("TPU v5 lite") is None
