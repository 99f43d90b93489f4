"""Tensor-parallel fleet replicas in the port: serve_fleet with
`model_axis_size=2` on two gloo CPU ranks (tests/test_torch_dist_worker.py
"fleet" cases, which never import jax), held to the JAX package's
serve_fleet and serve_paged without a mesh (its own meshed fleet test,
tests/test_paged_tp.py::test_fleet_replicas_get_meshes, needs a
shard_map that this jax refuses):

  * greedy tokens identical to the JAX fleet's and to JAX serve_paged's,
    under the "prefix" policy with the radix cache and under
    "round_robin" through the paged kernels' plain versions;
  * every replica reads mesh_shape "model=2" on both ranks, and both
    ranks ran the same sharded forwards (tp_psums, counted where the
    programs run);
  * the two replicas of a rank share one shard of the tree;
  * in one process, `model_axis_size=1` serves each replica on its own
    {"model": 1} mesh, token-identical to serve_paged.

One spawn of 2 ranks serves both policies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.fleet.api import serve_fleet as jserve_fleet
from defer_tpu.models.gpt import tiny_gpt as jtiny_gpt
from defer_tpu.runtime.paged import serve_paged as jserve_paged
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.fleet.api import serve_fleet
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.runtime.paged import serve_paged
from test_torch_dist_worker import spawn

CPU = torch.device("cpu")
GPT = dict(num_layers=4, dim=64, num_heads=4, ffn_dim=128, vocab_size=128,
           max_len=64, norm_style="pre")
BASE = dict(num_blocks=16, block_size=4, max_batch=2)
POLICIES = {
    "prefix": dict(policy="prefix", prefix_cache=True),
    "round_robin": dict(policy="round_robin", attention="pallas"),
}


def _requests():
    """A shared prefix on the first two (the radix cache and the router
    see it), a third unrelated prompt."""
    rng = np.random.default_rng(3)
    base = rng.integers(1, 128, size=(1, 8)).astype(np.int32)
    ext = rng.integers(1, 128, size=(1, 4)).astype(np.int32)
    return [(base, 7), (np.concatenate([base, ext], axis=1), 5),
            (rng.integers(1, 128, size=(1, 11)).astype(np.int32), 6)]


@pytest.fixture(scope="module")
def model():
    dec = jtiny_gpt(64)
    params = dec.init(jax.random.key(0))
    return dec, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    _, _, params = model
    cases = [dict(name=name, run="fleet", axes={"model": 2}, cfg=GPT,
                  params=params, requests=_requests(),
                  knobs=dict(BASE, n_replicas=2, model_axis_size=2, **knobs))
             for name, knobs in POLICIES.items()]
    got = spawn({"cases": cases}, 2, str(tmp_path_factory.mktemp("fleet_tp")))
    return {name: [r[name] for r in got] for name in POLICIES}


def _jreqs():
    return [(jnp.asarray(p), s) for p, s in _requests()]


@pytest.mark.parametrize("name", list(POLICIES))
def test_tokens_match_jax_fleet_and_serve_paged(model, ranks, devices, name):
    dec, params, _ = model
    knobs = POLICIES[name]
    jfleet, _ = jserve_fleet(dec, params, _jreqs(), n_replicas=2,
                             devices=devices[:2], **BASE, **knobs)
    paged_knobs = {k: v for k, v in knobs.items() if k != "policy"}
    jpaged, _ = jserve_paged(dec, params, _jreqs(), **BASE, **paged_knobs)
    ctl, follower = ranks[name]
    assert follower["tokens"] == []
    assert len(ctl["tokens"]) == 3
    for i, (got, a, b) in enumerate(zip(ctl["tokens"], jfleet, jpaged)):
        np.testing.assert_array_equal(got, np.asarray(a),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(got, np.asarray(b),
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("name", list(POLICIES))
def test_every_replica_reads_model_2_on_both_ranks(ranks, name):
    ctl, follower = ranks[name]
    for res in (ctl, follower):
        assert res["mesh_shapes"] == ["model=2", "model=2"]
        assert res["dead"] == [None, None]
    assert ctl["tp_psums"] == follower["tp_psums"]
    assert sum(ctl["tp_psums"]) > 0


@pytest.mark.parametrize("name", list(POLICIES))
def test_replicas_of_a_rank_share_one_shard(ranks, name):
    for res in ranks[name]:
        assert res["shards"] == 1


def test_model_axis_size_1_in_one_process():
    dec = GptDecoder(ts.TransformerConfig(**GPT), compute_dtype=torch.float32,
                     device=CPU)
    jdec = jtiny_gpt(64)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.key(0))), device=CPU)
    reqs = [(torch.from_numpy(p).long(), s) for p, s in _requests()]
    want, _ = serve_paged(dec, params, reqs, **BASE)
    outs, stats = serve_fleet(dec, params, reqs, n_replicas=2,
                              model_axis_size=1, devices=[CPU], **BASE)
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert [r["mesh_shape"] for r in stats["replicas"]] == ["model=1"] * 2
