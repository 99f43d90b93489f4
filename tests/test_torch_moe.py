"""The port's mixture-of-experts FFN (defer_tpu_torch's
parallel/transformer_stack.py: `_route_topk`, `moe_ffn`,
`moe_ffn_a2a`, `a2a_slots`) against the JAX package's, at an expert
axis of 1, where both dispatches are single-device programs.

Expert weights and activations are numpy draws (the biases too, so they
count) given to both packages. Float32: outputs agree within rtol 1e-5
/ atol 1e-5 (the same products summed in another order); routing, and
with it the a2a dispatch's drop set, must be identical.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel import mesh
from defer_tpu_torch.parallel import transformer_stack as ts

CPU = torch.device("cpu")
E, D, F = 4, 16, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _expert_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "router": rng.standard_normal((D, E)).astype(np.float32),
        "w1": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        "b1": rng.standard_normal((E, F)).astype(np.float32) * 0.1,
        "w2": rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5,
        "b2": rng.standard_normal((E, D)).astype(np.float32) * 0.1,
    }


def _x(seed=1, shape=(2, 12, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_keep(p, x, k, cap):
    """The JAX package's a2a drop set, from its own routing: (token,
    expert) kept where its arrival position in the expert is < cap."""
    idx, w = jts._route_topk(jnp.asarray(p["router"]),
                             jnp.asarray(x.reshape(-1, D)), k)
    member, _ = jts._dispatch_weights(idx, w, E)
    member = np.asarray(member).astype(np.int64)
    pos = np.cumsum(member, axis=0) - 1
    return (pos < cap) & (member > 0)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dispatch", ["dense", "a2a"])
def test_moe_ffn_matches_jax(dispatch, k):
    p, x = _expert_params(), _x()
    if dispatch == "dense":
        want = jts.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(x), top_k=k)
        got = ts.moe_ffn(params_from_jax(p, CPU), torch.from_numpy(x),
                         top_k=k)
    else:
        want = jts.moe_ffn_a2a(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), capacity_factor=1.25, top_k=k)
        got = ts.moe_ffn_a2a(params_from_jax(p, CPU), torch.from_numpy(x),
                             capacity_factor=1.25, top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_a2a_equals_dense_at_a_capacity_that_cannot_drop(k):
    """cf >= E / k gives every expert room for every token it could get."""
    p, x = params_from_jax(_expert_params(), CPU), torch.from_numpy(_x())
    dense = ts.moe_ffn(p, x, top_k=k)
    a2a = ts.moe_ffn_a2a(p, x, capacity_factor=E / k, top_k=k)
    torch.testing.assert_close(a2a, dense, **TOL)
    # Top-2 engages a second expert: it differs from top-1.
    if k == 2:
        assert not torch.allclose(dense, ts.moe_ffn(p, x, top_k=1))


@pytest.mark.parametrize("k", [1, 2])
def test_drop_set_at_cf_1_25_is_the_jax_packages(k):
    p, x = _expert_params(2), _x(3, (4, 16, D)) + 1.0
    p["router"][:, 0] += 0.1  # expert 0 favored: its queue overflows
    n = x.shape[0] * x.shape[1]
    cap = ts.moe_capacity(n, E, k, 1.25)
    assert cap == max(1, math.ceil(1.25 * k * n / E))
    idx, w = ts._route_topk(torch.from_numpy(p["router"]),
                            torch.from_numpy(x.reshape(n, D)), k)
    _, _, keep = ts.a2a_slots(idx, w, E, cap)
    want = _jax_keep(p, x, k, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    dropped = int(k * n - want.sum())
    assert dropped > 0, "cf 1.25 on this routing should drop something"


def test_routing_ties_take_the_lower_expert_first():
    """lax.top_k puts the lower index first among equal probabilities;
    the port's stable sort must too (it decides routing and drops)."""
    router = np.zeros((D, E), np.float32)
    router[:, 1] = router[:, 3] = 1.0  # experts 1 and 3 always tie
    x = np.abs(_x(4, (5, D)))
    for k in (1, 2, 3):
        jidx, jw = jts._route_topk(jnp.asarray(router), jnp.asarray(x), k)
        idx, w = ts._route_topk(torch.from_numpy(router),
                                torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)


def test_moe_gradients_match_jax():
    """Both dispatches differentiate like the JAX package's, at cf 1.25
    (drops included) and k = 2."""
    p, x = _expert_params(), _x()
    for fn, jfn, kw in ((ts.moe_ffn, jts.moe_ffn, {}),
                        (ts.moe_ffn_a2a, jts.moe_ffn_a2a,
                         {"capacity_factor": 1.25})):
        jgrads = jax.grad(
            lambda q, xx: jnp.sum(jnp.sin(jfn(q, xx, top_k=2, **kw))),
            argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x))
        tp = {k: v.requires_grad_() for k, v in params_from_jax(p,
                                                                CPU).items()}
        tx = torch.from_numpy(x).requires_grad_()
        torch.sin(fn(tp, tx, top_k=2, **kw)).sum().backward()
        for name in ("w1", "b1", "w2", "b2", "router"):
            np.testing.assert_allclose(tp[name].grad.numpy(),
                                       np.asarray(jgrads[0][name]),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dispatch,k", [("dense", 1), ("a2a", 2)])
def test_spmd_bert_with_experts_matches_jax(devices, dispatch, k):
    cfg_kw = dict(num_layers=4, dim=32, num_heads=4, ffn_dim=64,
                  vocab_size=64, max_len=32, num_experts=4, moe_top_k=k,
                  moe_dispatch=dispatch, capacity_factor=1.25)
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": 2}, devices[:2]),
                      jts.TransformerConfig(**cfg_kw),
                      compute_dtype=jnp.float32)
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [CPU, CPU]),
                  ts.TransformerConfig(**cfg_kw), compute_dtype=torch.float32)
    jparams = jsb.init(jax.random.key(0))
    ids = np.random.default_rng(1).integers(0, 64, (3, 2, 8)).astype(np.int32)
    want = np.asarray(jsb.make_step()(jparams, jnp.asarray(ids)))
    got = sb.make_step()(params_from_jax(jparams, CPU), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_capacity_factor_and_top_k_validated_as_jax():
    for bad in (dict(capacity_factor=0.0), dict(moe_top_k=5)):
        kw = dict(num_experts=4, **bad)
        with pytest.raises(ValueError) as jerr:
            jts.TransformerConfig(**kw)
        with pytest.raises(ValueError) as err:
            ts.TransformerConfig(**kw)
        assert str(err.value) == str(jerr.value)
    cfg = dataclasses.replace(ts.TransformerConfig(num_experts=2),
                              num_layers=1, dim=8, num_heads=2, ffn_dim=8)
    p = ts.init_stack(torch.Generator().manual_seed(0), cfg)
    assert p["w1"].shape == (1, 2, 8, 8) and p["b2"].shape == (1, 2, 8)
    assert p["router"].shape == (1, 8, 2)
