"""Expert parallelism, LoRA under tp, FSDP and ZeRO-1 on the port's
collectives (a gloo process group of 2 CPU ranks) against the JAX
package's layouts:

  * one MoE FFN at an expert axis of 2, dense and a2a, top-1 and top-2,
    against the JAX package's under shard_map, and the a2a dispatch's
    drop set at cf 1.25 (each rank's tokens, its capacity a rank's)
    against the one the JAX package's routing gives;
  * SpmdBert training over {"stage": 1, "expert": 2} in both dispatches,
    make_lora_train_step over {"stage": 1, "model": 2} (adapters on a
    column- and a row-parallel target), FSDP with remat and LoRA
    factors, FSDP with ZeRO-1, plain dp with ZeRO-1 (bit for bit against
    plain dp), and SpmdVit's FSDP forward.

One spawn runs every case of this file (tests/test_torch_dist_worker.py);
tolerances as tests/test_torch_dist.py states them; the MoE FFN's output
within rtol / atol 1e-5 (tests/test_torch_moe.py's), the drop set equal.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from defer_tpu.models.vit import SpmdVit as JaxSpmdVit
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import transformer_stack as jts
from test_torch_dist import BERT, FWD, _np, check_train, train_case
from test_torch_dist_worker import spawn

E, D, F, CF = 4, 16, 32, 1.25
MOE = dict(rtol=1e-5, atol=1e-5)
MOE_CASES = [(d, k) for d in ("dense", "a2a") for k in (1, 2)]
LAYOUTS = {
    "ep2_dense_top2": ({"stage": 1, "expert": 2},
                       dict(BERT, num_experts=4, moe_top_k=2), {}),
    "ep2_a2a_top1": ({"stage": 1, "expert": 2},
                     dict(BERT, num_experts=4, moe_dispatch="a2a",
                          capacity_factor=CF), {}),
    "tp2_lora": ({"stage": 1, "model": 2},
                 dict(BERT, lora_rank=4, lora_alpha=8.0,
                      lora_targets=("wq", "wv", "w2")), {"lora": True}),
    "dp2_fsdp_remat_lora": ({"data": 2, "stage": 1},
                            dict(BERT, remat=True, lora_rank=4),
                            {"fsdp": True}),
    "dp2_fsdp_zero1": ({"data": 2, "stage": 1}, BERT,
                       {"fsdp": True, "zero1": True}),
    "dp2_zero1": ({"data": 2, "stage": 1}, BERT, {"zero1": True}),
}
VIT_CFG = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=1,
               max_len=64, norm_style="pre")
VIT_KW = dict(image_size=16, patch_size=4, num_classes=5)


def _expert_params():
    rng = np.random.default_rng(0)
    return {
        "router": rng.standard_normal((D, E)).astype(np.float32),
        "w1": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        "b1": rng.standard_normal((E, F)).astype(np.float32) * 0.1,
        "w2": rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5,
        "b2": rng.standard_normal((E, D)).astype(np.float32) * 0.1,
    }


def _moe_case(dispatch, k):
    x = np.random.default_rng(1).standard_normal((2, 12, D)).astype(
        np.float32)
    return dict(name=f"moe_{dispatch}_{k}", run="moe",
                axes={"stage": 1, "expert": 2}, dispatch=dispatch, k=k,
                cf=CF, expert_params=_expert_params(), x=x)


def _vit_case(devices):
    jsv = JaxSpmdVit(jmesh.make_mesh({"data": 2, "stage": 1}, devices[:2]),
                     jts.TransformerConfig(**VIT_CFG),
                     compute_dtype=jnp.float32, fsdp=True, **VIT_KW)
    jparams = jsv.init(jax.random.key(0))
    images = np.random.default_rng(2).standard_normal(
        (3, 2, 16, 16, 3)).astype(np.float32)
    case = dict(name="vit_dp2_fsdp", run="vit", axes={"data": 2, "stage": 1},
                cfg=VIT_CFG, vit=VIT_KW, fsdp=True, params=_np(jparams),
                images=images)
    return case, (jsv, jparams)


@pytest.fixture(scope="module")
def world2(devices, tmp_path_factory):
    cases = [_moe_case(d, k) for d, k in MOE_CASES]
    jax_sides = {}
    for name, (axes, cfg, kw) in LAYOUTS.items():
        case, jax_side = train_case(devices, name, axes, cfg, **kw)
        cases.append(case)
        jax_sides[name] = (case, jax_side)
    vit, jax_sides["vit"] = _vit_case(devices)
    cases.append(vit)
    results = spawn({"cases": cases}, 2,
                    str(tmp_path_factory.mktemp("moe")))[0]
    return results, {c["name"]: c for c in cases}, jax_sides


def _jax_moe(devices, case):
    """The JAX package's FFN at an expert axis of 2, under shard_map."""
    spec = {"router": P(), "w1": P("expert"), "b1": P("expert"),
            "w2": P("expert"), "b2": P("expert")}
    if case["dispatch"] == "a2a":
        fn = functools.partial(jts.moe_ffn_a2a, capacity_factor=CF)
    else:
        fn = jts.moe_ffn
    body = functools.partial(fn, ep_axis="expert", top_k=case["k"])
    run = jax.shard_map(body, mesh=Mesh(np.array(devices[:2]), ("expert",)),
                        in_specs=(spec, P()), out_specs=P())
    p = jax.tree_util.tree_map(jnp.asarray, case["expert_params"])
    return np.asarray(run(p, jnp.asarray(case["x"])))


def _jax_keep(case, ep=2):
    """The drop set the JAX package's routing gives each rank's slice of
    the tokens at a rank's capacity: (token, expert) kept where its
    arrival position in the expert is below the capacity."""
    x = case["x"].reshape(-1, D)
    n_l = x.shape[0] // ep
    cap = max(1, math.ceil(CF * case["k"] * n_l / E))
    keeps = []
    for r in range(ep):
        idx, w = jts._route_topk(jnp.asarray(case["expert_params"]["router"]),
                                 jnp.asarray(x[r * n_l:(r + 1) * n_l]),
                                 case["k"])
        member, _ = jts._dispatch_weights(idx, w, E)
        member = np.asarray(member).astype(np.int64)
        pos = np.cumsum(member, axis=0) - 1
        keeps.append((pos < cap) & (member > 0))
    return np.concatenate(keeps)


@pytest.mark.parametrize("dispatch,k", MOE_CASES)
def test_moe_ffn_at_expert_axis_2_matches_jax(world2, devices, dispatch, k):
    results, cases, _ = world2
    case = cases[f"moe_{dispatch}_{k}"]
    got = results[case["name"]]
    np.testing.assert_allclose(got["forward"], _jax_moe(devices, case),
                               **MOE)
    np.testing.assert_array_equal(got["keep"], _jax_keep(case))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_expert_lora_fsdp_zero1_layouts_train_as_jax(world2, name):
    results, _, jax_sides = world2
    case, jax_side = jax_sides[name]
    check_train(results[name], jax_side, case)


def test_vit_fsdp_forward_matches_jax(world2):
    results, cases, jax_sides = world2
    jsv, jparams = jax_sides["vit"]
    want = jsv.make_step()(jparams, jnp.asarray(cases["vit_dp2_fsdp"][
        "images"]))
    np.testing.assert_allclose(results["vit_dp2_fsdp"]["forward"],
                               np.asarray(want), **FWD)
