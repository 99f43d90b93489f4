"""graph/serialize.py through both packages: the architecture wire is
shared, so the same graph gives the same JSON text in either package,
and a document from one package loads and runs in the other.

Weights are the JAX package's random init carried over with
`params_from_jax`; inputs are numpy draws from a fixed seed. Everything
runs in float32 on the CPU; outputs must agree within atol 1e-5 (the
packages sum the same dense layers in different orders).
"""

import json

import jax
import numpy as np
import pytest
import torch

from defer_tpu.graph import serialize as jser
from defer_tpu.graph.ir import GraphBuilder as JaxGraphBuilder
from defer_tpu.graph.partition import partition as jax_partition
from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.graph.ir import GraphBuilder, GraphError
from defer_tpu_torch.graph.partition import partition, stage_params
from defer_tpu_torch.graph.serialize import (
    frames_to_params,
    graph_from_json,
    graph_to_json,
    params_to_frames,
)
from defer_tpu_torch.models import get_model
from tests.test_partition import residual_chain

ATOL = 1e-5


def _skip_graph(builder_cls):
    """A chain whose cells consume their two predecessors: no single
    tensor separates it, so its cuts are bundles."""
    gb = builder_cls("skip")
    v = gb.input()
    h_prev = gb.add("dense", v, name="h0", features=16)
    h = gb.add("dense", h_prev, name="h1", features=16)
    for i in range(2, 5):
        nxt = gb.add("add", h, h_prev, name=f"mix{i}")
        nxt = gb.add("dense", nxt, name=f"h{i}", features=16)
        h_prev, h = h, nxt
    return gb.build(gb.add("dense", h, name="head", features=4))


@pytest.mark.parametrize(
    "name,kwargs,cuts",
    [
        ("resnet50", {}, ["add_8"]),
        ("bert_tiny", {"seq_len": 16}, ["encoder_0_out", "encoder_2_out"]),
        ("nasnet_mobile", {}, []),
    ],
)
def test_graph_json_text_equals_the_reference(name, kwargs, cuts):
    """The same graph and every stage of its cut: the same JSON text."""
    g, jg = get_model(name, **kwargs).graph, jax_get_model(name, **kwargs).graph
    assert graph_to_json(g) == jser.graph_to_json(jg)
    stages, jstages = partition(g, cuts), jax_partition(jg, cuts)
    assert len(stages) == len(jstages) == len(cuts) + 1
    for st, jst in zip(stages, jstages):
        assert graph_to_json(st) == jser.graph_to_json(jst)


def test_bundle_stage_json_equals_the_reference():
    st = partition(_skip_graph(GraphBuilder), [("h2", "h1")])[1]
    jst = jax_partition(_skip_graph(JaxGraphBuilder), [("h2", "h1")])[1]
    text = graph_to_json(st)
    assert text == jser.graph_to_json(jst)
    back = graph_from_json(text)
    assert back.input_names == ("h2", "h1") and back.output_names == ("head",)


def test_reference_document_runs_in_the_port():
    """A JAX-package graph's JSON, loaded by the port and applied to the
    reference's weights, gives the reference's output."""
    jg = residual_chain()
    jparams = jg.init(jax.random.key(0), (2, 8))
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    g = graph_from_json(jser.graph_to_json(jg))
    assert graph_to_json(g) == jser.graph_to_json(jg)
    got = g.apply(params_from_jax(jparams, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jg.apply(jparams, x)), atol=ATOL
    )
    # And back: the port's text loads in the reference.
    jg2 = jser.graph_from_json(graph_to_json(g))
    assert [n.name for n in jg2.nodes] == [n.name for n in jg.nodes]


def test_round_trip_keeps_tuples_and_applies_identically():
    g = get_model("bert_tiny", seq_len=16).graph
    g2 = graph_from_json(graph_to_json(g))
    assert (g2.name, g2.input_name, g2.output_name) == (
        g.name, g.input_name, g.output_name,
    )
    for a, b in zip(g.nodes, g2.nodes):
        assert (a.name, a.op, a.inputs) == (b.name, b.op, b.inputs)
        assert dict(a.attrs) == dict(b.attrs)
    params = g.init(torch.Generator().manual_seed(0), (2, 16),
                    input_dtype=torch.int32)
    ids = torch.from_numpy(
        np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)
    )
    torch.testing.assert_close(g2.apply(params, ids), g.apply(params, ids),
                               rtol=0, atol=0)


def test_param_frames_match_the_reference_and_round_trip():
    jg = residual_chain()
    jparams = jg.init(jax.random.key(0), (2, 8))
    params = params_from_jax(jparams, device="cpu")
    pairs = params_to_frames(params)
    assert [p for p, _ in pairs] == [p for p, _ in jser.params_to_frames(jparams)]
    back = frames_to_params(pairs)
    assert back == {k: dict(v) for k, v in params.items() if v}
    # Keys and shapes are the JAX package's (HWIO conv kernels too).
    rp = get_model("resnet50").graph
    shapes = jax.eval_shape(
        lambda k: jax_get_model("resnet50").init(k), jax.random.key(0)
    )
    conv = rp.node_map["conv1_conv"]
    wire = dict(params_to_frames({conv.name: {
        k: torch.empty(v.shape) for k, v in shapes[conv.name].items()
    }}))
    assert tuple(wire["conv1_conv/kernel"].shape) == (7, 7, 3, 64)


def test_stage_params_survive_the_wire():
    g = _skip_graph(GraphBuilder)
    params = g.init(torch.Generator().manual_seed(0), (2, 16))
    st = partition(g, [("h2", "h1")])[1]
    sp = stage_params(params, st)
    st2 = graph_from_json(graph_to_json(st))
    sp2 = frames_to_params(params_to_frames(sp))
    acts = (torch.ones(2, 16), torch.full((2, 16), 2.0))
    torch.testing.assert_close(st2.apply(sp2, acts), st.apply(sp, acts),
                               rtol=0, atol=0)


def test_graph_json_rejects_malformed():
    with pytest.raises(GraphError, match="not a graph"):
        graph_from_json("{]")
    with pytest.raises(GraphError, match="not a graph"):
        graph_from_json(json.dumps({"no": "nodes"}))
    with pytest.raises(GraphError, match="wire version"):
        graph_from_json(
            json.dumps({"wire_version": 99, "nodes": [], "name": "x"})
        )
    doc = json.loads(jser.graph_to_json(residual_chain()))
    del doc["nodes"][0]["op"]
    with pytest.raises(GraphError, match="malformed"):
        graph_from_json(json.dumps(doc))


def test_param_frames_reject_slash_and_bad_paths():
    with pytest.raises(GraphError, match="contains '/'"):
        params_to_frames({"n": {"a/b": torch.zeros(1)}})
    with pytest.raises(GraphError, match="malformed param path"):
        frames_to_params([("noslash", torch.zeros(1))])
