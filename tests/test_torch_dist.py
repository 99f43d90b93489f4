"""The port's collectives (defer_tpu_torch/parallel/collectives.py, over
a gloo process group of CPU ranks) against the JAX package's layouts on
its 8 virtual CPU devices: SpmdBert's forward, gradients and AdamW steps
at world size 4 (tp, dp x tp with ZeRO-1, the stage axis across ranks
under tp, pp x sp, the llama knobs and LoRA under dp x tp); the
placements (stack_specs, the FSDP plans), the layout helpers of
multihost.py and its backend rule.

The JAX side runs each layout (its own mesh of the same axes) in this
process; the port's ranks (tests/test_torch_dist_worker.py, which never
imports jax) get the JAX package's init and batches as numpy through
tmp_path, one spawn for every case of this file. Stated tolerances, all
float32:
  * forward: rtol / atol 2e-5 (the same math summed in another order);
  * step 1's gradients, gathered whole: rtol 1e-4 / atol 1e-6, as
    tests/test_torch_train.py holds one device's against
    jax.value_and_grad;
  * the 3 losses: rtol 1e-4; the parameters after 3 AdamW steps (lr
    1e-3, optax.adamw's decay 1e-4): atol 1e-5, 1% of one step, for
    every element whose step-1 gradient is above the gradients' atol.
    Adam moves a weight by about lr x sign(g), so an element whose
    gradient is float noise (all of bk's: a key bias shifts every logit
    of a query alike, so its gradient is zero in exact arithmetic) moves
    by up to lr either way, and is held to Adam's bound, 2 x steps x
    lr;
  * ZeRO-1 against plain dp: bit for bit (the same elementwise update
    on a slice).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
from defer_tpu.models.llama import llama_config as jax_llama_config
from defer_tpu.parallel import lora as jlora
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import multihost as jmultihost
from defer_tpu.parallel import train as jtrain
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch.models.llama import llama_config
from defer_tpu_torch.parallel import mesh, multihost
from defer_tpu_torch.parallel import transformer_stack as ts
from test_torch_dist_worker import spawn

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAMS_ATOL = 1e-5
BERT = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=16)
LLAMA = dict(num_layers=4, dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
             vocab_size=64, max_len=16)
CLASSES, STEPS, LR, WD = 4, 3, 1e-3, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_case(devices, name, axes, cfg, *, llama=False, lora=False,
               zero1=False, batch=(2, 4, 8), seed=1, **sb_kw):
    """A "train" case for the ranks and the JAX package's own run of the
    same layout: its SpmdBert, train step, init state and batch."""
    n = math.prod(axes.values())
    jcfg = (jax_llama_config if llama else jts.TransformerConfig)(**cfg)
    jsb = JaxSpmdBert(jmesh.make_mesh(axes, devices[:n]), jcfg,
                      compute_dtype=jnp.float32, **sb_kw)
    opt = optax.adamw(LR, weight_decay=WD)
    if lora:
        jinit, jstep = jlora.make_lora_train_step(jsb, opt,
                                                  num_classes=CLASSES)
        jstate, jbase = jinit(jax.random.key(0))
        trainable = _np(jstate.params)
        full = jlora.combine_lora(_np(jbase), trainable)
        full.update(cls_w=trainable["cls_w"], cls_b=trainable["cls_b"])
    else:
        jinit, jstep = jtrain.make_train_step(jsb, opt, num_classes=CLASSES)
        jstate, jbase = jinit(jax.random.key(0)), None
        full = _np(jstate.params)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"], batch).astype(np.int32)
    labels = rng.integers(0, CLASSES, batch[:2]).astype(np.int32)
    case = dict(name=name, run="train", axes=axes, cfg=cfg, llama=llama,
                lora=lora, zero1=zero1, params=full, ids=ids, labels=labels,
                classes=CLASSES, steps=STEPS, lr=LR, wd=WD, **sb_kw)
    jax_side = dict(jsb=jsb, jstep=jstep, jstate=jstate, jbase=jbase,
                    lora=lora)
    return case, jax_side


def _loss_fn(jsb, lora, base):
    forward = jsb.make_step()

    def loss(trainable, ids, labels):
        params = jlora.combine_lora(base, trainable) if lora else trainable
        logits = forward(params, ids) @ trainable["cls_w"] + \
            trainable["cls_b"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    return loss


def _assert_tree(got, want, err="", **tol):
    assert sorted(got) == sorted(want), err
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], f"{err}/{k}", **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=f"{err}/{k}", **tol)


def _assert_stepped(got, want, grads, steps, err="param"):
    """Parameters after Adam steps (module docstring): PARAMS_ATOL where
    the step-1 gradient is above GRAD's atol, Adam's bound elsewhere."""
    assert sorted(got) == sorted(want), err
    for k in want:
        if isinstance(want[k], dict):
            _assert_stepped(got[k], want[k], grads[k], steps, f"{err}/{k}")
            continue
        diff = np.abs(got[k] - want[k])
        real = np.abs(grads[k]) >= GRAD["atol"]
        assert diff[real].max(initial=0) <= PARAMS_ATOL, (
            err, k, diff[real].max())
        assert diff.max() <= 2 * steps * LR, (err, k, diff.max())


def check_train(got, jax_side, case):
    """The ranks' forward, step-1 gradients, losses and parameters after
    the steps against the JAX package's run of the same layout."""
    jsb, jstate = jax_side["jsb"], jax_side["jstate"]
    base = jax_side["jbase"]
    ids, labels = jnp.asarray(case["ids"]), jnp.asarray(case["labels"])
    params = (jlora.combine_lora(base, jstate.params) if jax_side["lora"]
              else jstate.params)
    np.testing.assert_allclose(
        got["forward"], np.asarray(jsb.make_step()(params, ids)), **FWD)
    loss, grads = jax.value_and_grad(
        _loss_fn(jsb, jax_side["lora"], base))(jstate.params, ids, labels)
    _assert_tree(got["grads"], _np(grads), "grad", **GRAD)
    losses = []
    for _ in range(case["steps"]):
        if jax_side["lora"]:
            jstate, jl = jax_side["jstep"](jstate, base, ids, labels)
        else:
            jstate, jl = jax_side["jstep"](jstate, ids, labels)
        losses.append(float(jl))
    np.testing.assert_allclose(got["plain_losses"][0], float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(got["plain_losses"], losses, rtol=1e-4)
    _assert_stepped(got["plain_params"], _np(jstate.params), _np(grads),
                    case["steps"])
    if case["zero1"]:
        assert got["zero1_losses"] == got["plain_losses"]
        _assert_tree(got["zero1_params"], got["plain_params"], "zero1",
                     rtol=0, atol=0)


LAYOUTS = {
    "tp4": ({"stage": 1, "model": 4}, BERT, {}),
    "dp2_tp2_zero1": ({"data": 2, "stage": 1, "model": 2}, BERT,
                      {"zero1": True}),
    "stage2_tp2": ({"stage": 2, "model": 2}, BERT, {}),
    "stage2_seq2": ({"stage": 2, "seq": 2},
                    dict(BERT, norm_style="pre", causal=True), {}),
    "llama_tp2_dp2": ({"data": 2, "stage": 1, "model": 2}, LLAMA,
                      {"llama": True}),
    "lora_tp2_dp2": ({"data": 2, "stage": 1, "model": 2},
                     dict(BERT, lora_rank=4, lora_alpha=8.0,
                          lora_targets=("wq", "wo", "w1")), {"lora": True}),
}


@pytest.fixture(scope="module")
def world4(devices, tmp_path_factory):
    cases, jax_sides = [], {}
    for name, (axes, cfg, kw) in LAYOUTS.items():
        case, jax_side = train_case(devices, name, axes, cfg, **kw)
        cases.append(case)
        jax_sides[name] = (case, jax_side)
    results = spawn({"cases": cases}, 4,
                    str(tmp_path_factory.mktemp("world4")))[0]
    return results, jax_sides


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_trains_as_jax(world4, name):
    results, jax_sides = world4
    case, jax_side = jax_sides[name]
    check_train(results[name], jax_side, case)


def test_initialize_is_explicit_about_its_backend(monkeypatch):
    """No world size: a single-process run joins nothing. NCCL without a
    card of its own for the rank raises before joining, naming gloo;
    an unknown backend is refused."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    topo = multihost.initialize()
    assert topo["process_count"] == 1 and topo["backend"] is None
    assert not torch.distributed.is_initialized()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("tcp://127.0.0.1:1", cards + 1, cards,
                             local_rank=cards)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        multihost.initialize(backend="mpi")
    assert not torch.distributed.is_initialized()


def test_layout_helpers_match_jax(devices):
    """dcn_aware_axes on one host keeps the order; stage_submeshes splits
    an outermost stage axis and refuses as the JAX package does."""
    axes = {"model": 2, "stage": 2}
    assert multihost.dcn_aware_axes(axes) == jmultihost.dcn_aware_axes(
        axes) == axes
    cpu = [torch.device("cpu")] * 4
    subs = multihost.stage_submeshes(mesh.make_mesh({"stage": 2,
                                                     "model": 2}, cpu))
    want = jmultihost.stage_submeshes(jmesh.make_mesh({"stage": 2,
                                                       "model": 2},
                                                      devices[:4]))
    assert [s.shape for s in subs] == [dict(w.shape) for w in want]
    for bad in ({"model": 2, "stage": 2}, {"model": 4}):
        with pytest.raises(ValueError) as err:
            multihost.stage_submeshes(mesh.make_mesh(bad, cpu))
        with pytest.raises(ValueError) as jerr:
            jmultihost.stage_submeshes(jmesh.make_mesh(bad, devices[:4]))
        assert str(err.value) == str(jerr.value)


def test_specs_and_fsdp_plans_match_jax():
    """stack_specs (MoE, llama and LoRA key sets), fsdp_plan and
    fsdp_specs give the JAX package's placements, entry for entry."""
    for cfg_kw, moe in ((dict(BERT, num_experts=4), True),
                        (dict(BERT, lora_rank=2,
                              lora_targets=("wq", "wo", "w2")), False)):
        jcfg, cfg = jts.TransformerConfig(**cfg_kw), ts.TransformerConfig(
            **cfg_kw)
        for tp, ep in ((None, None), ("model", "expert")):
            want = jts.stack_specs(None, tp, ep_axis=ep, moe=moe, cfg=jcfg)
            got = ts.stack_specs(None, tp, ep_axis=ep, moe=moe, cfg=cfg)
            assert {k: tuple(v) for k, v in want.items()} == got
            for dp in (2, 4):
                plan = ts.fsdp_plan(cfg, got, dp)
                assert plan == jts.fsdp_plan(jcfg, want, dp)
                assert {k: tuple(v) for k, v in jts.fsdp_specs(
                    want, plan, "data").items()} == ts.fsdp_specs(
                        got, plan, "data")
    lcfg = jax_llama_config(**LLAMA)
    assert {k: tuple(v) for k, v in jts.stack_specs(
        "stage", "model", cfg=lcfg).items()} == ts.stack_specs(
            "stage", "model", cfg=llama_config(**LLAMA))
