"""The port's SPMD encoder stack on a stage mesh (defer_tpu_torch's
parallel/mesh.py make_mesh, parallel/spmd_pipeline.py, the block of
parallel/transformer_stack.py, SpmdBert and SpmdVit) against the JAX
package's.

Weights come from the JAX package's init and cross through numpy
(`params_from_jax`); the JAX side runs on the 8 virtual CPU devices of
tests/conftest.py at compute_dtype=float32 (no Pallas on the CPU: its
attention takes the XLA path), the port on make_mesh({"stage": S},
[cpu] * S), whose trees have the same [S, L/S, ...] layout. Outputs
agree within rtol 2e-5 / atol 2e-5 in float32: the same math, summed in
another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
from defer_tpu.models.llama import llama_config as jax_llama_config
from defer_tpu.models.vit import SpmdVit as JaxSpmdVit
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import spmd_pipeline as jsp
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch import params_from_jax, params_to_numpy
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.models.llama import llama_config
from defer_tpu_torch.models.vit import SpmdVit
from defer_tpu_torch.parallel import mesh, spmd_pipeline
from defer_tpu_torch.parallel import transformer_stack as ts

CPU = torch.device("cpu")
RTOL = ATOL = 2e-5
BERT = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=32)
LLAMA = dict(num_layers=4, dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
             vocab_size=64, max_len=32)


def _port_mesh(axes):
    return mesh.make_mesh(axes, [CPU] * int(np.prod(list(axes.values()))))


def _ids(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_make_mesh_shapes_devices_and_refusal(devices):
    m = mesh.make_mesh({"data": 1, "stage": 4}, [CPU] * 4)
    assert m.axis_names == ("data", "stage")
    assert m.shape == {"data": 1, "stage": 4} == dict(
        jmesh.make_mesh({"data": 1, "stage": 4}, devices[:4]).shape)
    assert m.axis_devices("stage") == [CPU] * 4
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        mesh.make_mesh({"stage": 4}, [CPU] * 2)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        jmesh.make_mesh({"stage": 4}, devices[:2])
    assert set(mesh.describe_topology()) == set(jmesh.describe_topology())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh({"stage": 1})


def test_pipeline_equals_sequential():
    """4 stages in turn == the 4 stage functions applied in order; the
    output is exactly [M, B, ...]."""
    m = _port_mesh({"stage": 4})
    params = {"w": torch.arange(1.0, 5.0).reshape(4, 1),
              "b": torch.arange(0.0, 4.0).reshape(4, 1)}
    run = spmd_pipeline.make_spmd_pipeline(
        m, lambda p, x: x * p["w"] + p["b"])
    xs = torch.arange(6.0).reshape(6, 1, 1)
    ys = run(params, xs)
    want = xs
    for s in range(4):
        want = want * params["w"][s, 0] + params["b"][s, 0]
    assert ys.shape == xs.shape
    torch.testing.assert_close(ys, want, rtol=0, atol=0)


def test_stack_and_unstack_match_jax():
    tree = {"a": np.arange(24.0).reshape(4, 3, 2), "b": np.arange(8.0)}
    want = jsp.stack_for_stages(tree, 2)
    got = spmd_pipeline.stack_for_stages(params_from_jax(tree, CPU), 2)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = spmd_pipeline.unstack_stages(got)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        spmd_pipeline.stack_for_stages(params_from_jax(tree, CPU), 3)


def _bert_pair(devices, cfg_kw, stages, llama=False, **kw):
    jcfg = (jax_llama_config(**cfg_kw) if llama
            else jts.TransformerConfig(**cfg_kw))
    cfg = llama_config(**cfg_kw) if llama else ts.TransformerConfig(**cfg_kw)
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": stages}, devices[:stages]),
                      jcfg, compute_dtype=jnp.float32, **kw)
    sb = SpmdBert(_port_mesh({"stage": stages}), cfg,
                  compute_dtype=torch.float32, **kw)
    return jsb, sb


@pytest.mark.parametrize(
    "cfg_kw,llama,stages",
    [(BERT, False, 1), (BERT, False, 2),
     (dict(BERT, norm_style="pre", causal=True), False, 2),
     (LLAMA, True, 1), (LLAMA, True, 2)],
    ids=["post-s1", "post-s2", "pre-causal-s2", "llama-s1", "llama-s2"],
)
def test_spmd_bert_matches_jax(devices, cfg_kw, llama, stages):
    """Pooled and hidden steps and the unpipelined reference equal the
    JAX package's on its init; llama = rms norms, swiglu, rope, GQA (4
    query heads over 2 KV heads) and no biases."""
    jsb, sb = _bert_pair(devices, cfg_kw, stages, llama)
    jparams = jsb.init(jax.random.key(0))
    params = params_from_jax(jparams, CPU)
    assert ("pos_embedding" in params) == (not llama)
    assert params["stack"]["wq"].shape[:2] == (stages, 4 // stages)
    ids = _ids((3, 2, 8), 64)
    want = np.asarray(jsb.make_step()(jparams, jnp.asarray(ids)))
    got = sb.make_step()(params, torch.from_numpy(ids))
    assert got.shape == (3, 2, cfg_kw["dim"])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sb.reference_apply(params, torch.from_numpy(ids)
                                                  ).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    hidden = sb.make_hidden_step()(params, torch.from_numpy(ids))
    np.testing.assert_allclose(
        hidden.numpy(),
        np.asarray(jsb.make_hidden_step()(jparams, jnp.asarray(ids))),
        rtol=RTOL, atol=ATOL)


def test_init_draws_the_jax_key_set_and_shapes(devices):
    for llama, kw in ((False, dict(BERT, lora_rank=2)), (True, LLAMA),
                      (False, dict(BERT, num_experts=4))):
        jsb, sb = _bert_pair(devices, kw, 2, llama)
        want = jax.eval_shape(jsb.init, jax.random.key(0))
        got = sb.init(torch.Generator().manual_seed(0))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(params_to_numpy(got))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(params_to_numpy(got))):
            assert a.shape == b.shape and b.dtype == np.float32


def test_remat_forward_and_grads_equal_plain_ones():
    """cfg.remat runs each block under torch.utils.checkpoint: the same
    forward and the same gradients (the backward recomputes)."""
    outs = []
    for remat in (False, True):
        cfg = ts.TransformerConfig(**BERT, remat=remat)
        sb = SpmdBert(_port_mesh({"stage": 2}), cfg,
                      compute_dtype=torch.float32)
        params = sb.init(torch.Generator().manual_seed(0))
        w = params["stack"]["w1"].requires_grad_()
        y = sb.make_step()(params, torch.from_numpy(_ids((2, 2, 8), 64)))
        (g,) = torch.autograd.grad(y.square().sum(), w)
        outs.append((y.detach(), g))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stages", [1, 2])
def test_spmd_vit_matches_jax(devices, stages):
    cfg_kw = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64,
                  vocab_size=1, max_len=64, norm_style="pre")
    kw = dict(image_size=16, patch_size=4, num_classes=5)
    jsv = JaxSpmdVit(jmesh.make_mesh({"stage": stages}, devices[:stages]),
                     jts.TransformerConfig(**cfg_kw),
                     compute_dtype=jnp.float32, **kw)
    sv = SpmdVit(_port_mesh({"stage": stages}), ts.TransformerConfig(**cfg_kw),
                 compute_dtype=torch.float32, **kw)
    jparams = jsv.init(jax.random.key(0))
    params = params_from_jax(jparams, CPU)
    images = np.random.default_rng(2).standard_normal(
        (3, 2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jsv.make_step()(jparams, jnp.asarray(images)))
    got = sv.make_step()(params, torch.from_numpy(images))
    assert got.shape == (3, 2, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        sv.reference_apply(params, torch.from_numpy(images)).numpy(), want,
        rtol=2e-4, atol=2e-5)


MESH_CASES = [
    # (axes, cfg overrides, fsdp): each refused by the JAX package.
    ({"data": 2}, {}, False),                          # no stage axis
    ({"stage": 3}, {}, False),                         # 4 layers / 3
    ({"stage": 1, "expert": 2}, {"num_experts": 3}, False),
    ({"stage": 1, "expert": 2}, {}, False),            # experts == 0
    ({"stage": 1, "model": 3}, {}, False),             # heads % tp
    ({"stage": 2}, {}, True),                          # fsdp, no data
]


@pytest.mark.parametrize("axes,over,fsdp", MESH_CASES)
def test_mesh_validations_raise_as_jax(devices, axes, over, fsdp):
    n = int(np.prod(list(axes.values())))
    cfg_kw = dict(BERT, **over)
    with pytest.raises(ValueError) as jerr:
        JaxSpmdBert(jmesh.make_mesh(axes, devices[:n]),
                    jts.TransformerConfig(**cfg_kw), fsdp=fsdp)
    with pytest.raises(ValueError) as err:
        SpmdBert(_port_mesh(axes), ts.TransformerConfig(**cfg_kw), fsdp=fsdp)
    assert str(err.value) == str(jerr.value)


def test_vit_validations_raise_as_jax(devices):
    cfg_kw = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64,
                  norm_style="pre")
    for over, kw in (({"norm_style": "post"}, {}), ({"num_layers": 3}, {}),
                     ({}, {"image_size": 17}), ({}, {"fsdp": True})):
        c = dict(cfg_kw, **over)
        kw = dict(dict(image_size=16, patch_size=4), **kw)
        with pytest.raises(ValueError) as jerr:
            JaxSpmdVit(jmesh.make_mesh({"stage": 2}, devices[:2]),
                       jts.TransformerConfig(**c), **kw)
        with pytest.raises(ValueError) as err:
            SpmdVit(_port_mesh({"stage": 2}), ts.TransformerConfig(**c), **kw)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("axis", ["data", "model", "seq", "expert"])
def test_a_non_stage_axis_larger_than_one_names_item_7(axis):
    """Without a process group a mesh axis but "stage" larger than 1 is
    refused after the JAX package's validations, naming the call that
    makes one (multihost.initialize); fsdp=True over such a data axis
    is planned first (the JAX package's rule), then refused alike."""
    cfg = ts.TransformerConfig(**BERT, num_experts=2 if axis == "expert"
                               else 0)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        SpmdBert(_port_mesh({"stage": 2, axis: 2}), cfg)
    vit_cfg = dataclasses.replace(cfg, norm_style="pre")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        SpmdVit(_port_mesh({"stage": 2, axis: 2}), vit_cfg, image_size=16,
                patch_size=4)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        SpmdBert(_port_mesh({"stage": 1, "data": 2}), cfg, fsdp=True)


def test_collective_sites_are_identities_at_size_one():
    """An axis the model does not split over (None) is the identity; a
    named axis outside a distributed mesh's run raises, naming
    multihost.initialize."""
    x = torch.randn(2, 3)
    assert ts.psum(x, None) is x and ts.all_gather(x, None, dim=0) is x
    assert ts.all_to_all(x, None, split_axis=0, concat_axis=1) is x
    assert ts.pvary(x, None) is x
    assert ts.axis_size(None) == 1 and ts.axis_index(None) == 0
    for call in (lambda: ts.psum(x, "model"), lambda: ts.axis_size("expert"),
                 lambda: ts.all_gather(x, "data", dim=0)):
        with pytest.raises(RuntimeError, match="multihost.initialize"):
            call()
