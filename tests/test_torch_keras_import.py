"""graph/keras_import.py through both packages: the same Keras JSON
gives the same IR nodes (names, ops, inputs, attrs), the same cut
candidates and the same logits.

Fixtures are in-test JSON documents (the JAX package's `_residual_json`,
a Sequential MLP, a Keras 3 document); weights are the JAX package's
random init carried over with `params_from_jax`; inputs are numpy draws
from a fixed seed. Float32 on the CPU; logits within atol 1e-5.
"""

import json
import queue
import threading

import jax
import numpy as np
import pytest
import torch

from defer_tpu.graph import keras_import as jki
from defer_tpu_torch import DEFER, DeferConfig, params_from_jax
from defer_tpu_torch.graph.keras_import import (
    KerasImportError,
    from_keras_json,
    model_from_keras,
    supported_layers,
)
from tests.test_keras_import import _layer, _residual_json

CPU = torch.device("cpu")
ATOL = 1e-5


def _sequential_json():
    return json.dumps({
        "class_name": "Sequential",
        "config": {
            "name": "seq_mlp",
            "layers": [
                {"class_name": "Dense",
                 "config": {"name": "d1", "units": 8, "activation": "relu",
                            "batch_input_shape": [None, 4]}},
                {"class_name": "Dropout", "config": {"name": "dr"}},
                {"class_name": "Dense",
                 "config": {"name": "d2", "units": 3,
                            "activation": "softmax"}},
            ],
        },
    })


def _tensor(name):
    return {"class_name": "__keras_tensor__",
            "config": {"keras_history": [name, 0, 0]}}


def _keras3_json():
    """Keras 3's layout: dict inbound nodes of __keras_tensor__ args,
    `batch_shape` on the input, flat single-io input/output specs."""
    def layer(cls, name, args, **cfg):
        cfg.setdefault("name", name)
        return {"class_name": cls, "name": name, "config": cfg,
                "inbound_nodes": [{"args": args, "kwargs": {}}] if args
                else []}

    layers = [
        layer("InputLayer", "inp", [], batch_shape=[None, 8, 8, 3]),
        layer("Conv2D", "c1", [_tensor("inp")], filters=4,
              kernel_size=[3, 3], padding="same", activation="swish"),
        layer("DepthwiseConv2D", "dw", [_tensor("c1")], kernel_size=[3, 3],
              padding="same", use_bias=False),
        layer("Concatenate", "cat", [[_tensor("c1"), _tensor("dw")]],
              axis=-1),
        layer("GlobalMaxPooling2D", "gmp", [_tensor("cat")]),
        layer("Dense", "out", [_tensor("gmp")], units=5),
    ]
    return json.dumps({"class_name": "Functional", "config": {
        "name": "k3", "layers": layers,
        "input_layers": ["inp", 0, 0], "output_layers": ["out", 0, 0],
    }})


def _nodes(graph):
    return [(n.name, n.op, tuple(n.inputs), dict(n.attrs))
            for n in graph.nodes]


@pytest.mark.parametrize(
    "doc", [_residual_json, _sequential_json, _keras3_json],
    ids=["residual", "sequential", "keras3"],
)
def test_same_nodes_and_logits_as_the_reference(doc):
    text = doc()
    graph, shape = from_keras_json(text)
    jgraph, jshape = jki.from_keras_json(text)
    assert shape == jshape
    assert (graph.name, graph.input_name, graph.output_name) == (
        jgraph.name, jgraph.input_name, jgraph.output_name,
    )
    assert _nodes(graph) == _nodes(jgraph)
    jparams = jgraph.init(jax.random.key(0), (2, *shape))
    x = np.random.default_rng(0).standard_normal((2, *shape)).astype(
        np.float32
    )
    got = graph.apply(params_from_jax(jparams, CPU), torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jgraph.apply(jparams, x)), atol=ATOL
    )


def test_model_from_keras_discovers_the_references_cuts():
    model, params = model_from_keras(_residual_json())
    jmodel, _ = jki.model_from_keras(_residual_json())
    assert params is None
    assert model.cut_candidates == jmodel.cut_candidates
    assert "add_1" in model.cut_candidates
    assert model.input_shape == (16, 16, 3)
    assert supported_layers() == jki.supported_layers()


def write_classic_h5(h5py, path, weights: dict) -> None:
    """{layer: [arrays]} in the classic (TF2-era) HDF5 layout:
    `layer_names` on the root, `weight_names` on each layer group."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode() for n in weights]
        for lname, arrays in weights.items():
            g = f.create_group(lname)
            names = [f"{lname}/w{i}:0" for i in range(len(arrays))]
            g.attrs["weight_names"] = [n.encode() for n in names]
            for n, a in zip(names, arrays):
                g.create_dataset(n, data=a)


def test_weights_h5_raises_naming_the_roadmap_item(tmp_path):
    """weights_h5= loads since the port reads Keras HDF5 weights
    (tests/test_torch_keras_h5.py holds it against tf.keras): the
    residual JSON's params written in the classic h5 layout come back bit
    for bit, and a file that is not there raises (h5py's OSError) where
    the port used to raise NotImplementedError naming its ROADMAP item."""
    h5py = pytest.importorskip("h5py")
    from defer_tpu_torch.models.transplant import export_keras_weights

    model, _ = model_from_keras(_residual_json())
    params = model.init(torch.Generator().manual_seed(3))
    path = str(tmp_path / "w.h5")
    write_classic_h5(h5py, path, export_keras_weights(model.graph, params))
    _, loaded = model_from_keras(_residual_json(), weights_h5=path,
                                 generator=torch.Generator())
    for node, ps in params.items():
        for p, v in ps.items():
            assert torch.equal(loaded[node][p], v), (node, p)
    with pytest.raises(OSError):
        model_from_keras(_residual_json(), weights_h5=str(tmp_path / "no.h5"),
                         generator=torch.Generator())


def test_build_pipeline_takes_a_keras_json_string():
    """DEFER accepts the reference's wire format: a Keras JSON string
    through run_defer on "auto" cuts (two stages on two CPU slots) gives
    the imported graph's own forward."""
    text = _residual_json()
    model, _ = model_from_keras(text)
    params = model.init(torch.Generator().manual_seed(3), batch_size=2)
    defer = DEFER(devices=[CPU] * 2,
                  config=DeferConfig(compute_dtype=torch.float32))
    xs = [torch.from_numpy(
        np.random.default_rng(i).standard_normal((2, 16, 16, 3)).astype(
            np.float32))
        for i in range(3)]
    in_q, out_q = queue.Queue(), queue.Queue()
    for x in xs:
        in_q.put(x)
    in_q.put(None)
    t = threading.Thread(
        target=defer.run_defer, args=(text, "auto", in_q, out_q),
        kwargs={"params": params}, daemon=True,
    )
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert defer.last_pipeline.num_stages == 2
    for x in xs:
        torch.testing.assert_close(
            out_q.get_nowait(), model.graph.apply(params, x),
            rtol=0, atol=ATOL,
        )


@pytest.mark.parametrize(
    "layers,match",
    [
        ([_layer("InputLayer", "i", [], batch_input_shape=[None, 4, 4, 3]),
          _layer("LSTM", "l", ["i"], units=2)], "unsupported Keras layer"),
        ([_layer("InputLayer", "i", [], batch_input_shape=[None, 4, 4, 3]),
          _layer("Conv2D", "c", ["i"], filters=2, kernel_size=[1, 1],
                 data_format="channels_first")], "channels_first"),
        ([_layer("InputLayer", "i", [], batch_input_shape=[None, None, 4, 3]),
          _layer("Flatten", "f", ["i"])], "variable dims"),
    ],
    ids=["unsupported", "channels_first", "variable_dims"],
)
def test_refusals_match_the_reference(layers, match):
    text = json.dumps({"class_name": "Functional", "config": {
        "name": "bad", "layers": layers,
        "input_layers": [[layers[0]["name"], 0, 0]],
        "output_layers": [[layers[-1]["name"], 0, 0]],
    }})
    for fn in (from_keras_json, jki.from_keras_json):
        with pytest.raises(ValueError, match=match):
            fn(text)
    with pytest.raises(KerasImportError):
        from_keras_json(text)
