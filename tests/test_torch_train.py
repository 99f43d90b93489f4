"""The port's trainers (defer_tpu_torch/parallel/train.py: classifier,
LM and DPO steps; runtime/checkpoint.py's train states) against the JAX
package's optax steps.

Both packages start from the JAX package's init (copied into the port's
TrainState through numpy) on a stage-2 mesh (the JAX one on the virtual
CPU devices of tests/conftest.py), float32, the same batches. Stated
tolerances: a loss within rtol 1e-5 and gradients within rtol 1e-4 /
atol 1e-6 of jax.value_and_grad (the same math summed in another
order); loss trajectories over a few Adam steps within rtol 1e-4 (Adam's
first steps are near lr * sign(g), so trajectories are compared, not
parameters after many steps); served greedy tokens identical.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
from defer_tpu.models.gpt import GptDecoder as JaxGptDecoder
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import train as jtrain
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu.runtime.decode_server import serve_greedy as jax_serve_greedy
from defer_tpu_torch import params_from_jax, params_to_numpy
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.parallel import mesh, train
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.parallel.spmd_pipeline import unstack_stages
from defer_tpu_torch.runtime.checkpoint import (
    load_train_state,
    save_train_state,
)
from defer_tpu_torch.runtime.decode_server import serve_greedy

CPU = torch.device("cpu")
BASE = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=16)
LM = dict(BASE, norm_style="pre", causal=True)


def _pair(devices, cfg_kw, stages=2):
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": stages}, devices[:stages]),
                      jts.TransformerConfig(**cfg_kw),
                      compute_dtype=jnp.float32)
    sb = SpmdBert(mesh.make_mesh({"stage": stages}, [CPU] * stages),
                  ts.TransformerConfig(**cfg_kw), compute_dtype=torch.float32)
    return jsb, sb


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(state, tree):
    """The JAX package's values into a port TrainState's params."""
    src = params_from_jax(tree, CPU)

    def copy(dst, s):
        for k in dst:
            if isinstance(dst[k], dict):
                copy(dst[k], s[k])
            else:
                dst[k].copy_(s[k])

    with torch.no_grad():
        copy(state.params, src)
    return state


def _batch(m=3, b=2, s=8, classes=4, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (m, b, s)).astype(np.int32),
            rng.integers(0, classes, (m, b)).astype(np.int32))


def _classifier(devices, cfg_kw, joptax, topt):
    jsb, sb = _pair(devices, cfg_kw)
    jinit, jstep = jtrain.make_train_step(jsb, joptax, num_classes=4)
    jstate = jinit(jax.random.key(0))
    init, step = train.make_train_step(sb, topt, num_classes=4)
    state = _load(init(torch.Generator().manual_seed(0)),
                  _np(jstate.params))
    return jsb, jstate, jstep, state, step


def test_classifier_loss_and_gradients_match_jax(devices):
    jsb, jstate, _, state, step = _classifier(
        devices, BASE, optax.sgd(0.0),
        functools.partial(torch.optim.SGD, lr=0.0))
    ids, labels = _batch()
    forward = jsb.make_step()

    def loss_fn(params):
        logits = forward(params, jnp.asarray(ids)) @ params["cls_w"] + \
            params["cls_b"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    want, grads = jax.value_and_grad(loss_fn)(jstate.params)
    state, loss = step(state, torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict)
               else v.grad) for k, v in state.params.items()}
    flat_want = jax.tree_util.tree_leaves_with_path(_np(grads))
    assert len(flat_want) == len(train.tree_leaves(got))
    for path, g in flat_want:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf.numpy(), g, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert int(state.step) == 1


@pytest.mark.parametrize("cfg_kw,steps", [
    (BASE, 5),
    # Routed tokens sit at capacity edges and near-tied gates, where
    # Adam's g / sqrt(v) on near-zero router gradients amplifies
    # last-ulp differences step by step (1e-7 relative at step 1, 3e-4
    # by step 5): three steps.
    (dict(BASE, num_layers=2, num_experts=4, moe_top_k=2,
          moe_dispatch="a2a", capacity_factor=1.25), 3)],
    ids=["bert", "moe-a2a-top2"])
def test_adamw_losses_match_optax(devices, cfg_kw, steps):
    """optax.adamw and torch.optim.AdamW with the same settings (optax's
    weight decay 1e-4; torch's default would be 1e-2)."""
    _, jstate, jstep, state, step = _classifier(
        devices, cfg_kw, optax.adamw(1e-2, weight_decay=1e-4),
        functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4))
    ids, labels = _batch()
    want, got = [], []
    for _ in range(steps):
        jstate, jl = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        state, loss = step(state, torch.from_numpy(ids),
                           torch.from_numpy(labels))
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_step_keeps_the_loss_on_the_device_and_updates_in_place():
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                  ts.TransformerConfig(**BASE), compute_dtype=torch.float32)
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.Adam, lr=1e-2), num_classes=4)
    state = init(torch.Generator().manual_seed(0))
    w = state.params["stack"]["wq"]
    before = w.detach().clone()
    ids, labels = _batch()
    new, loss = step(state, torch.from_numpy(ids), torch.from_numpy(labels))
    assert new is state and state.params["stack"]["wq"] is w
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0
    assert not loss.requires_grad and not torch.equal(w, before)
    assert [id(p) for p in state.opt_state.param_groups[0]["params"]] == \
        [id(p) for p in train.tree_leaves(state.params)]


def _flatten(params):
    """Detached params with the stage stack flattened: GptDecoder's tree."""
    out = {k: v.detach().clone() for k, v in params.items() if k != "stack"}
    out["stack"] = {k: v.detach().clone()
                    for k, v in unstack_stages(params["stack"]).items()}
    return out


def test_lm_train_then_serve_on_the_decoder(devices):
    """Next-token training through the pipeline (the first steps' losses
    as the JAX package's), then the trained tree, stack flattened, serves
    on the port's GptDecoder: the corpus loss falls by half, the
    pipeline's last-position logits equal the decoder's, and greedy
    tokens from serve_greedy equal the JAX package's server on the same
    weights."""
    jsb, sb = _pair(devices, LM)
    jinit, jstep = jtrain.make_lm_train_step(jsb, optax.adam(5e-3))
    jstate = jinit(jax.random.key(0))
    fresh = _np(jstate.params)
    init, step = train.make_lm_train_step(
        sb, functools.partial(torch.optim.Adam, lr=5e-3))
    state = _load(init(torch.Generator().manual_seed(0)), fresh)
    ids = np.random.default_rng(1).integers(0, 64, (2, 4, 12)).astype(
        np.int32)
    want, losses = [], []
    for i in range(30):
        if i < 3:
            jstate, jl = jstep(jstate, jnp.asarray(ids))
            want.append(float(jl))
        state, loss = step(state, torch.from_numpy(ids))
        losses.append(float(loss))
    np.testing.assert_allclose(losses[:3], want, rtol=1e-4)
    assert losses[-1] < 0.5 * losses[0], losses

    dec = GptDecoder(ts.TransformerConfig(**LM), compute_dtype=torch.float32,
                     device=CPU)
    flat_ids = torch.from_numpy(ids).reshape(-1, 12).long()

    def corpus_loss(dparams):
        logits = dec.reference_logits(dparams, flat_ids)
        return float(torch.nn.functional.cross_entropy(
            logits[:, :-1].flatten(0, 1), flat_ids[:, 1:].flatten()))

    trained = _flatten(state.params)
    assert corpus_loss(trained) < 0.5 * corpus_loss(
        _flatten(params_from_jax(fresh, CPU)))
    want_logits = dec.reference_logits(trained, flat_ids[:4])[:, -1]
    got_logits = train._lm_logits(sb, state.params,
                                  torch.from_numpy(ids))[0, :, -1]
    torch.testing.assert_close(got_logits.detach(), want_logits, rtol=2e-4,
                               atol=2e-4)

    prompts = [(flat_ids[i : i + 1, :5], 6) for i in range(3)]
    outs, _ = serve_greedy(dec, trained, prompts, max_batch=2)
    jdec = JaxGptDecoder(jts.TransformerConfig(**LM),
                         compute_dtype=jnp.float32)
    jouts, _ = jax_serve_greedy(
        jdec, jax.tree_util.tree_map(jnp.asarray, params_to_numpy(trained)),
        [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in prompts],
        max_batch=2)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


def _dpo_batch(m=2, b=4):
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 64, (m, b, 4))
    chosen = np.concatenate([prompt, rng.integers(0, 64, (m, b, 8))], -1)
    rejected = np.concatenate([prompt, rng.integers(0, 64, (m, b, 8))], -1)
    mask = np.concatenate([np.zeros((m, b, 4)), np.ones((m, b, 8))], -1)
    return [a.astype(np.int32) for a in (chosen, rejected, mask, mask)]


def test_dpo_learns_preferences_as_jax(devices):
    """Step 1 sits at log 2 (policy = reference); the first steps' loss
    and accuracy are the JAX package's; 25 steps drive the loss under
    log 2 and the pair accuracy to 1; the reference tree never changes,
    bit for bit."""
    jsb, sb = _pair(devices, LM)
    jinit, jstep = jtrain.make_dpo_train_step(jsb, optax.adam(5e-3),
                                              beta=0.5)
    jstate = jinit(jax.random.key(0))
    jref = jax.tree_util.tree_map(jnp.array, jstate.params)
    init, step = train.make_dpo_train_step(
        sb, functools.partial(torch.optim.Adam, lr=5e-3), beta=0.5)
    state = _load(init(torch.Generator().manual_seed(0)),
                  _np(jstate.params))
    ref = params_from_jax(_np(jstate.params), CPU)
    ref_before = params_to_numpy(ref)
    batch = _dpo_batch()
    tb = [torch.from_numpy(a) for a in batch]
    losses, accs, want = [], [], []
    for i in range(25):
        if i < 2:
            jstate, (jl, ja) = jstep(jstate, jref,
                                     *(jnp.asarray(a) for a in batch))
            want.append((float(jl), float(ja)))
        state, (loss, acc) = step(state, ref, *tb)
        losses.append(float(loss))
        accs.append(float(acc))
    assert abs(losses[0] - np.log(2.0)) < 1e-6
    np.testing.assert_allclose([x for x, _ in want], losses[:2], rtol=1e-4)
    assert [a for _, a in want] == accs[:2]
    assert losses[-1] < float(np.log(2.0)) and accs[-1] == 1.0, losses
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_numpy(ref), ref_before)
    pi_c = train.sequence_logprobs(sb, state.params, tb[0], tb[2])
    pi_r = train.sequence_logprobs(sb, state.params, tb[1], tb[3])
    assert bool((pi_c > pi_r).all())


def test_lm_and_dpo_refuse_what_jax_refuses(devices):
    for kw, match in ((BASE, "causal"), (dict(BASE, causal=True), "pre")):
        jsb, sb = _pair(devices, kw)
        for jmake, make in ((jtrain.make_lm_train_step,
                             train.make_lm_train_step),
                            (jtrain.make_dpo_train_step,
                             train.make_dpo_train_step)):
            with pytest.raises(ValueError, match=match):
                jmake(jsb, optax.adam(1e-3))
            with pytest.raises(ValueError, match=match):
                make(sb, functools.partial(torch.optim.Adam, lr=1e-3))


def test_remat_train_step_matches_exact():
    """Two steps with cfg.remat equal two without: the second step's
    loss depends on the first's gradients."""
    ids, labels = (torch.from_numpy(a) for a in _batch())
    traces = []
    for remat in (False, True):
        sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                      ts.TransformerConfig(**BASE, remat=remat),
                      compute_dtype=torch.float32)
        init, step = train.make_train_step(
            sb, functools.partial(torch.optim.Adam, lr=1e-3), num_classes=4)
        state = init(torch.Generator().manual_seed(0))
        state, l1 = step(state, ids, labels)
        _, l2 = step(state, ids, labels)
        traces.append((float(l1), float(l2)))
    np.testing.assert_allclose(traces[0], traces[1], rtol=1e-6)
    assert traces[0][1] != traces[0][0]


def test_zero1_without_a_data_axis_is_a_noop_and_fsdp_needs_one(devices):
    ids, labels = (torch.from_numpy(a) for a in _batch())
    cfg = ts.TransformerConfig(**BASE)
    runs = []
    for zero1 in (False, True):
        sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]), cfg,
                      compute_dtype=torch.float32)
        init, step = train.make_train_step(
            sb, functools.partial(torch.optim.Adam, lr=1e-3), num_classes=4,
            zero1=zero1)
        state = init(torch.Generator().manual_seed(0))
        runs.append([float(step(state, ids, labels)[1]) for _ in range(2)])
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="data"):
        JaxSpmdBert(jmesh.make_mesh({"stage": 2}, devices[:2]),
                    jts.TransformerConfig(**BASE), fsdp=True)
    with pytest.raises(ValueError, match="data"):
        SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]), cfg, fsdp=True)


def test_train_state_checkpoint_resumes_bit_for_bit(tmp_path):
    """save_train_state after a step, load_train_state into a state
    drawn from another seed (and with no optimizer state yet): both
    continue with the same loss and the same params, bit for bit."""
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                  ts.TransformerConfig(**BASE), compute_dtype=torch.float32)
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.AdamW, lr=1e-2,
                              weight_decay=1e-4), num_classes=3)
    state = init(torch.Generator().manual_seed(0))
    ids, labels = (torch.from_numpy(a) for a in _batch(classes=3))
    state, _ = step(state, ids, labels)
    path = os.path.join(tmp_path, "state.ckpt")
    save_train_state(path, state)
    restored = load_train_state(path, init(torch.Generator().manual_seed(9)))
    assert int(restored.step) == 1
    assert restored.opt_state.param_groups[0]["lr"] == 1e-2
    for _ in range(2):
        _, la = step(state, ids, labels)
        _, lb = step(restored, ids, labels)
        assert float(la) == float(lb)
    for a, b in zip(train.tree_leaves(state.params),
                    train.tree_leaves(restored.params)):
        assert torch.equal(a, b)


def test_llama_stack_trains_as_jax(devices):
    """The classifier on a llama-configured stack (rope, rms, GQA,
    swiglu, no biases): three Adam steps' losses as optax's."""
    from defer_tpu.models.llama import llama_config as jax_llama_config
    from defer_tpu_torch.models.llama import llama_config

    kw = dict(num_layers=2, dim=64, num_heads=4, num_kv_heads=2,
              ffn_dim=128, vocab_size=64, max_len=16)
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": 2}, devices[:2]),
                      jax_llama_config(**kw), compute_dtype=jnp.float32)
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                  dataclasses.replace(llama_config(**kw)),
                  compute_dtype=torch.float32)
    jinit, jstep = jtrain.make_train_step(jsb, optax.adam(1e-2),
                                          num_classes=4)
    jstate = jinit(jax.random.key(0))
    init, step = train.make_train_step(
        sb, functools.partial(torch.optim.Adam, lr=1e-2), num_classes=4)
    state = _load(init(torch.Generator().manual_seed(0)), _np(jstate.params))
    ids, labels = _batch()
    want, got = [], []
    for _ in range(3):
        jstate, jl = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        _, loss = step(state, torch.from_numpy(ids), torch.from_numpy(labels))
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
