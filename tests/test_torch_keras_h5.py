"""Keras HDF5 weights through the port (models/transplant.py
`load_keras_h5` / `export_keras_weights`, graph/keras_import.py
`model_from_keras(weights_h5=)`, models/pretrained.py), mirroring
tests/test_keras_parity.py against REAL tf.keras models.

Real tf.keras models with random weights (no network) are exported with
`to_json()` + `save_weights()`, at small input sizes so that the file
stays quick on the CPU. Each is ingested by the port two ways, through
its JSON and through the native zoo graph's `keras_name_map`: every
transplanted array must be bit-equal to what the JAX package's loader
and `KerasWeights` give for the same file, and the port's forward must
reproduce TF's (softmax outputs within rtol 2e-3 + atol 2e-6, the JAX
file's tolerance). Both on-disk dialects load alike in both packages
(Keras 3 `.weights.h5` from TF, and the classic `layer_names` layout
written here with h5py), `export_keras_weights` equals the JAX
package's, and `load_pretrained("random")` reproduces its tf.keras
model. "imagenet" is never tried (it would need the network). Skips
without tensorflow or h5py. Float32 on the CPU.
"""

import json
import os

os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

h5py = pytest.importorskip("h5py")
tf = pytest.importorskip("tensorflow")

from defer_tpu.models import get_model as jax_get_model  # noqa: E402
from defer_tpu.models import transplant as jtransplant  # noqa: E402
from defer_tpu_torch.graph.keras_import import model_from_keras  # noqa: E402
from defer_tpu_torch.graph.partition import partition, stage_params  # noqa: E402
from defer_tpu_torch.models import get_model  # noqa: E402
from defer_tpu_torch.models.pretrained import (  # noqa: E402
    PretrainedUnavailable,
    load_pretrained,
)
from defer_tpu_torch.models.transplant import (  # noqa: E402
    KerasWeights,
    export_keras_weights,
    load_keras_h5,
    transplant,
)
from tests.test_torch_keras_import import write_classic_h5  # noqa: E402

CPU = torch.device("cpu")
# (constructor, input shape): the smallest sizes each tf.keras model takes.
_KERAS_MODELS = {
    "resnet50": (lambda s: tf.keras.applications.ResNet50(
        weights=None, input_shape=s), (64, 64, 3)),
    "mobilenetv2": (lambda s: tf.keras.applications.MobileNetV2(
        weights=None, input_shape=s), (64, 64, 3)),
    "efficientnet_b0": (lambda s: tf.keras.applications.EfficientNetB0(
        weights=None, input_shape=s), (64, 64, 3)),
    "xception": (lambda s: tf.keras.applications.Xception(
        weights=None, input_shape=s), (71, 71, 3)),
    "nasnet_mobile": (lambda s: tf.keras.applications.NASNetMobile(
        weights=None, input_shape=s), (96, 96, 3)),
}


@pytest.fixture(scope="module")
def keras_artifacts(tmp_path_factory):
    """name -> (json_str, weights_path, tf_output, x), built once."""
    cache = {}

    def build(name):
        if name not in cache:
            make, shape = _KERAS_MODELS[name]
            km = make(shape)
            path = str(tmp_path_factory.mktemp("kw") / f"{name}.weights.h5")
            km.save_weights(path)
            x = np.random.RandomState(0).rand(1, *shape).astype("float32")
            y_tf = np.asarray(km(x, training=False))
            cache[name] = (km.to_json(), path, y_tf, x)
        return cache[name]

    return build


def _assert_close(y, y_tf, name):
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    assert y.shape == y_tf.shape
    # Softmax probabilities (~1e-3 each for random weights): compare on
    # that scale, as the JAX file does.
    np.testing.assert_allclose(y, y_tf, rtol=2e-3, atol=2e-6,
                               err_msg=f"{name}: diverged from tf.keras")


def _bit_equal_to_jax(graph, params, layer_weights, name_map=None):
    """Every array the port transplanted equals, bit for bit, what the
    JAX package's KerasWeights converts from the same dict."""
    src = jtransplant.KerasWeights(layer_weights,
                                   **({"name_map": name_map} if name_map
                                      else {}))
    n = 0
    for node in graph.nodes:
        for pname, got in params.get(node.name, {}).items():
            want = src.get(node, pname, tuple(got.shape))
            if want is None:
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{node.name}.{pname}")
            n += 1
    assert n > 0


@pytest.mark.parametrize("name", ["resnet50", "mobilenetv2",
                                  "efficientnet_b0", "xception"])
def test_json_plus_h5_reproduces_tf_forward(name, keras_artifacts):
    json_str, path, y_tf, x = keras_artifacts(name)
    model, params = model_from_keras(json_str, weights_h5=path,
                                     generator=torch.Generator())
    assert params is not None
    _bit_equal_to_jax(model.graph, params,
                      jtransplant.load_keras_h5(path, json_str))
    with torch.no_grad():
        y = model.graph.apply(params, torch.from_numpy(x))
    _assert_close(y, y_tf, name)


@pytest.mark.parametrize("name", ["resnet50", "mobilenetv2",
                                  "efficientnet_b0"])
def test_native_zoo_consumes_real_checkpoint(name, keras_artifacts):
    json_str, path, y_tf, x = keras_artifacts(name)
    model = get_model(name)
    assert model.keras_name_map is not None
    weights = load_keras_h5(path, json_str)
    params = transplant(
        model.graph, model.init(torch.Generator()),
        KerasWeights(weights, name_map=model.keras_name_map), strict=True,
    )
    _bit_equal_to_jax(model.graph, params, weights,
                      jax_get_model(name).keras_name_map)
    if name == "efficientnet_b0":
        # The native graph takes preprocessed input; the Keras model
        # embeds Rescaling(1/255) + Normalization (identity un-adapted).
        x = x / 255.0
    with torch.no_grad():
        y = model.graph.apply(params, torch.from_numpy(x))
    _assert_close(y, y_tf, name)


def test_native_xception_matches_tf(keras_artifacts):
    """The hand-built Xception graph reproduces a real tf.keras Xception
    from its checkpoint, the auto-named residual conv/BN pairs resolved
    from THIS model's JSON layer order."""
    from defer_tpu_torch.models.xception import _RES_ORDER

    json_str, path, y_tf, x = keras_artifacts("xception")
    layers = json.loads(json_str)["config"]["layers"]
    convs = [l["config"]["name"] for l in layers
             if l["class_name"] == "Conv2D"
             and l["config"]["name"].startswith("conv2d")]
    bns = [l["config"]["name"] for l in layers
           if l["class_name"] == "BatchNormalization"
           and l["config"]["name"].startswith("batch_normalization")]
    assert len(convs) == len(bns) == len(_RES_ORDER)
    remap = {f"{b}_res_conv": c for b, c in zip(_RES_ORDER, convs)}
    remap |= {f"{b}_res_bn": n for b, n in zip(_RES_ORDER, bns)}
    model = get_model("xception")

    def name_map(node, _inner=model.keras_name_map):
        return remap.get(node, _inner(node))

    params = transplant(
        model.graph, model.init(torch.Generator()),
        KerasWeights(load_keras_h5(path, json_str), name_map=name_map),
        strict=True,
    )
    with torch.no_grad():
        y = model.graph.apply(params, torch.from_numpy(x))
    _assert_close(y, y_tf, "xception")


def test_imported_nasnet_pipelines_via_bundle_discovery(keras_artifacts):
    """A real NASNetMobile imports with auto-discovered bundle boundaries
    and a 4-stage bundle pipeline reproduces its forward."""
    json_str, path, y_tf, x = keras_artifacts("nasnet_mobile")
    model, params = model_from_keras(json_str, weights_h5=path,
                                     generator=torch.Generator())
    assert any(isinstance(c, tuple) for c in model.cut_candidates)
    cuts = model.default_cuts(4)
    assert len(cuts) == 3
    h = torch.from_numpy(x)
    with torch.no_grad():
        for s in partition(model.graph, cuts):
            h = s.apply(stage_params(params, s), h)
    _assert_close(h, y_tf, "nasnet_mobile.pipeline4")


def test_both_h5_dialects_load_alike(keras_artifacts, tmp_path):
    """Keras 3's `.weights.h5` (resolved through the model JSON, and by
    raw group names without it) and the classic layout give the same
    {layer: [arrays]} in both packages, bit for bit."""
    json_str, path, _, _ = keras_artifacts("mobilenetv2")
    for mj in (json_str, None):
        got, want = load_keras_h5(path, mj), jtransplant.load_keras_h5(path,
                                                                       mj)
        assert list(got) == list(want) and len(got) > 50
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
    resolved = load_keras_h5(path, json_str)
    assert "Conv1" in resolved and "block_1_expand" in resolved
    classic = str(tmp_path / "classic.h5")
    write_classic_h5(h5py, classic, resolved)
    got, want = load_keras_h5(classic), jtransplant.load_keras_h5(classic)
    assert list(got) == list(resolved) == list(want)
    for k in got:
        for a, b, c in zip(got[k], resolved[k], want[k]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_export_keras_weights_round_trips(keras_artifacts):
    """export_keras_weights gives back the checkpoint's arrays (and the
    JAX package's export of the same params), and transplanting the
    export reproduces the params."""
    json_str, path, _, _ = keras_artifacts("mobilenetv2")
    model, params = model_from_keras(json_str, weights_h5=path,
                                     generator=torch.Generator())
    out = export_keras_weights(model.graph, params)
    ref = load_keras_h5(path, json_str)
    jout = jtransplant.export_keras_weights(
        model.graph, {n: {p: v.numpy() for p, v in ps.items()}
                      for n, ps in params.items()})
    assert set(out) == set(jout)
    for k, arrays in out.items():
        for a, b, c in zip(arrays, ref[k], jout[k]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    again = transplant(model.graph, params, KerasWeights(out))
    for n, ps in params.items():
        for p, v in ps.items():
            assert torch.equal(again[n][p], v)


def test_load_pretrained_random_reproduces_tf():
    """load_pretrained("random") builds a real tf.keras model with fresh
    weights (no network), transplants it through the zoo's name map, and
    reproduces its forward; a missing checkpoint path and a model with no
    tf.keras application raise PretrainedUnavailable."""
    model, params, km = load_pretrained("mobilenetv2", "random",
                                        device=CPU)
    assert km is not None
    x = np.random.RandomState(1).rand(1, 224, 224, 3).astype("float32")
    with torch.no_grad():
        y = model.graph.apply(params, torch.from_numpy(x))
    _assert_close(y, np.asarray(km(x, training=False)), "mobilenetv2")
    with pytest.raises(PretrainedUnavailable, match="does not exist"):
        load_pretrained("mobilenetv2", "/nonexistent/weights.h5",
                        device=CPU)
    with pytest.raises(PretrainedUnavailable, match="no tf.keras"):
        load_pretrained("xception", "random", device=CPU)
