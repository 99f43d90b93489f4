"""BERT through both packages: the graph, its partition, and run_defer.

Weights are the JAX package's random init (bert_tiny, seq 16), carried
over with `params_from_jax`; token ids are numpy draws from a fixed
seed. Everything runs in float32 on the CPU. Tolerance: atol 1e-4 (four
encoder blocks of float32 matmuls summed in different orders).
"""

import os
import queue
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defer_tpu
from defer_tpu.graph.partition import PartitionError as JaxPartitionError
from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch import DEFER, DeferConfig, params_from_jax, partition
from defer_tpu_torch.graph.partition import PartitionError, stage_params
from defer_tpu_torch.models import get_model

CPU = torch.device("cpu")
ATOL = 1e-4
CUTS = ["encoder_0_out", "encoder_2_out"]


@pytest.fixture(scope="module")
def bert():
    jmodel = jax_get_model("bert_tiny", seq_len=16)
    jparams = jmodel.init(jax.random.key(0), batch_size=2)
    ids = np.random.default_rng(0).integers(0, 128, (4, 2, 16))
    return jmodel, jparams, get_model("bert_tiny", seq_len=16), ids


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


def test_graph_matches_jax(bert):
    jmodel, jparams, model, ids = bert
    want = jmodel.graph.apply(jparams, jnp.asarray(ids[0], jnp.int32))
    got = model.graph.apply(params_from_jax(jparams), torch.from_numpy(ids[0]))
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_shapes_and_cuts_match_jax(bert):
    jmodel, jparams, model, _ = bert
    want = jmodel.graph.infer_shapes(jparams, (2, 16), jnp.int32)
    got = model.graph.infer_shapes(params_from_jax(jparams), (2, 16),
                                   torch.int64)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()
    }
    assert all(v.device.type == "meta" for v in got.values())
    for n in (1, 2, 4):
        assert model.default_cuts(n) == jmodel.default_cuts(n)


def test_partitioned_equals_whole(bert):
    _, jparams, model, ids = bert
    params = params_from_jax(jparams)
    x = torch.from_numpy(ids[1])
    stages = partition(model.graph, CUTS)
    assert len(stages) == 3
    h = x
    for stage in stages:
        h = stage.apply(stage_params(params, stage), h)
    torch.testing.assert_close(h, model.graph.apply(params, x))


def test_run_defer_matches_jax(bert):
    jmodel, jparams, model, ids = bert
    want = _run_stream(
        defer_tpu.DEFER(
            config=defer_tpu.DeferConfig(compute_dtype=jnp.float32)
        ),
        jmodel,
        CUTS,
        jparams,
        [jnp.asarray(x, jnp.int32) for x in ids],
    )
    defer = DEFER(
        devices=[CPU], config=DeferConfig(compute_dtype=torch.float32)
    )
    got = _run_stream(
        defer, model, CUTS, params_from_jax(jparams),
        [torch.from_numpy(x) for x in ids],
    )
    assert defer.last_pipeline.num_stages == 3
    assert len(got) == len(ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize(
    "cuts",
    [["encoder_0_mha"], ["encoder_2_out", "encoder_0_out"], ["nope"]],
)
def test_invalid_cut_raises_in_both(bert, cuts):
    jmodel, _, model, _ = bert
    with pytest.raises(JaxPartitionError) as jerr:
        defer_tpu.partition(jmodel.graph, cuts)
    with pytest.raises(PartitionError) as err:
        partition(model.graph, cuts)
    assert str(err.value) == str(jerr.value)


def test_params_from_jax_widens_bf16():
    tree = {"n": {"w": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16),
                  "i": np.arange(3, dtype=np.int32)}}
    out = params_from_jax(tree, CPU)
    assert out["n"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        out["n"]["w"].numpy(), np.asarray(tree["n"]["w"], np.float32)
    )
    assert out["n"]["i"].dtype == torch.int32
    assert params_from_jax(tree, CPU, torch.bfloat16)["n"]["w"].dtype == (
        torch.bfloat16
    )


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: DEFER() uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        DEFER()


@pytest.mark.parametrize(
    "kwargs,layers",
    [
        ({"replicas": 2}, CUTS),
        ({}, "auto"),
    ],
)
def test_unported_options_raise(bert, kwargs, layers):
    _, jparams, model, _ = bert
    defer = DEFER(devices=[CPU])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        defer.build_pipeline(
            model, layers, params=params_from_jax(jparams), **kwargs
        )


def test_keras_json_raises():
    with pytest.raises(NotImplementedError, match="Keras"):
        DEFER(devices=[CPU]).build_pipeline('{"class_name": "Model"}', None)


def test_import_leaves_jax_out():
    """The port and every submodule import without jax or defer_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import defer_tpu_torch\n"
        "for m in pkgutil.walk_packages(defer_tpu_torch.__path__, "
        "'defer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'defer_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
