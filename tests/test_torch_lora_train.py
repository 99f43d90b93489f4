"""LoRA fine-tuning on the port's stage pipeline
(defer_tpu_torch/parallel/lora.py `make_lora_train_step`) against the
JAX package's: the same init (the JAX package's, through numpy), the
same batches, optax.adam against torch.optim.Adam.

The base tree stays frozen (requires_grad False, no .grad ever built,
every tensor bit for bit as it started), the optimizer holds only the
adapter factors and the classifier head, and the losses follow the JAX
package's within rtol 1e-4 over three steps (float32; the same math
summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
from defer_tpu.parallel import lora as jlora
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel import lora, mesh, train
from defer_tpu_torch.parallel import transformer_stack as ts

CPU = torch.device("cpu")
CFG = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
           max_len=16, lora_rank=4, lora_alpha=8.0,
           lora_targets=("wq", "wv", "w2"))


def _copy(dst, src):
    with torch.no_grad():
        for k in dst:
            if isinstance(dst[k], dict):
                _copy(dst[k], src[k])
            else:
                dst[k].copy_(src[k])


def test_lora_train_freezes_the_base_and_matches_jax(devices):
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": 2}, devices[:2]),
                      jts.TransformerConfig(**CFG), compute_dtype=jnp.float32)
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                  ts.TransformerConfig(**CFG), compute_dtype=torch.float32)
    jinit, jstep = jlora.make_lora_train_step(jsb, optax.adam(1e-2),
                                              num_classes=3)
    jstate, jbase = jinit(jax.random.key(0))
    init, step = lora.make_lora_train_step(
        sb, functools.partial(torch.optim.Adam, lr=1e-2), num_classes=3)
    state, base = init(torch.Generator().manual_seed(0))
    _copy(state.params, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), CPU))
    _copy(base, params_from_jax(jax.tree_util.tree_map(np.asarray, jbase),
                                CPU))
    assert sorted(state.params["stack"]) == [
        "w2:a", "w2:b", "wq:a", "wq:b", "wv:a", "wv:b"]
    assert sorted(state.params) == ["cls_b", "cls_w", "stack"]
    n_opt = sum(len(g["params"]) for g in state.opt_state.param_groups)
    assert n_opt == len(train.tree_leaves(state.params)) == 8
    base_leaves = train.tree_leaves(base)
    before = [t.clone() for t in base_leaves]
    assert not any(t.requires_grad for t in base_leaves)

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (3, 2, 8)).astype(np.int32)
    labels = rng.integers(0, 3, (3, 2)).astype(np.int32)
    want, got = [], []
    for _ in range(3):
        jstate, jl = jstep(jstate, jbase, jnp.asarray(ids),
                           jnp.asarray(labels))
        state, loss = step(state, base, torch.from_numpy(ids),
                           torch.from_numpy(labels))
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for t, b in zip(base_leaves, before):
        assert t.grad is None and torch.equal(t, b)
    # The adapters moved (b starts at zero, so the first step moves it).
    assert float(state.params["stack"]["wq:b"].detach().abs().max()) > 0


def test_lora_train_needs_a_rank():
    sb = SpmdBert(mesh.make_mesh({"stage": 1}, [CPU]),
                  ts.TransformerConfig(**dict(CFG, lora_rank=0)))
    with pytest.raises(ValueError, match="lora_rank"):
        lora.make_lora_train_step(sb, torch.optim.Adam, num_classes=2)
