"""Tensor-parallel T5 in the port: SpmdT5 on two gloo CPU ranks
(tests/test_torch_dist_worker.py "t5" cases, which never import jax),
held to the JAX package's SpmdT5 on two of its virtual CPU devices, the
same weights through numpy (tests/test_t5.py's tp tests):

  * `generate`'s greedy tokens identical;
  * the incremental step's logits from `make_encode`'s cache, the
    teacher-forced `make_forward` on a masked ragged batch and the
    direct `forward` within rtol 2e-4 / atol 2e-5 (f32; the psums add
    the head groups in another order), [B, T, 97]: the vocab of 97
    pads to 98 rows over tp 2, a zero row each rank never looks up and
    the logits drop;
  * a tied relu config and an untied gated-gelu one;
  * each rank's caches hold its head group and its embedding shard the
    padded vocab rows / 2;
  * the constructor's refusals, word for word.

One spawn of 2 ranks serves both configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.t5 import SpmdT5 as JSpmdT5
from defer_tpu.models.t5 import spmd_t5 as jspmd_t5
from defer_tpu.models.t5 import tiny_t5 as jtiny_t5
from defer_tpu.parallel.mesh import make_mesh as jmake_mesh
from defer_tpu_torch.models import t5
from defer_tpu_torch.parallel import mesh
from test_torch_dist_worker import spawn

TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 5
CONFIGS = {
    "tied_relu": dict(vocab_size=97),
    "untied_gated": dict(vocab_size=97, ffn_style="gated-gelu",
                         tie_word_embeddings=False),
}


def _inputs():
    rng = np.random.default_rng(1)
    enc = rng.integers(1, 97, size=(2, 6)).astype(np.int32)
    dec = rng.integers(0, 97, size=(2, 4)).astype(np.int32)
    mask = np.asarray([[1, 1, 1, 1, 0, 0], [1] * 6], np.int32)
    return enc, dec, mask


@pytest.fixture(scope="module")
def jax_side(devices):
    """Each config's JAX SpmdT5 results on a {"model": 2} mesh."""
    enc, dec, mask = _inputs()
    jmesh = jmake_mesh({"model": 2}, devices[:2])
    out = {}
    for name, over in CONFIGS.items():
        single = jtiny_t5(**over)
        params = single.init(jax.random.key(0))
        tp = jspmd_t5(jmesh, single.cfg, compute_dtype=jnp.float32)
        sp = tp.shard_params(params)
        ones = jnp.ones(enc.shape, jnp.int32)
        _, cache = tp.make_encode()(sp, jnp.asarray(enc), ones)
        step, _ = tp.make_step(donate=False)(sp, cache, jnp.asarray(dec))
        out[name] = dict(
            cfg=dataclasses.asdict(single.cfg),
            params=jax.tree_util.tree_map(np.asarray, params),
            generate=np.asarray(tp.generate(sp, jnp.asarray(enc), STEPS)),
            step=np.asarray(step),
            forward=np.asarray(tp.make_forward()(
                sp, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(mask))),
            direct=np.asarray(tp.forward(sp, jnp.asarray(enc),
                                         jnp.asarray(dec))),
        )
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    enc, dec, mask = _inputs()
    cases = [dict(name=name, run="t5", axes={"model": 2}, cfg=side["cfg"],
                  params=side["params"], enc=enc, dec=dec, mask=mask,
                  steps=STEPS)
             for name, side in jax_side.items()]
    got = spawn({"cases": cases}, 2, str(tmp_path_factory.mktemp("t5_tp")))
    return {name: [r[name] for r in got] for name in CONFIGS}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_matches_jax_spmd_t5(jax_side, ranks, name):
    for res in ranks[name]:
        np.testing.assert_array_equal(res["generate"],
                                      jax_side[name]["generate"])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("what", ["step", "forward", "direct"])
def test_logits_match_jax_spmd_t5(jax_side, ranks, name, what):
    want = jax_side[name][what]
    assert want.shape[-1] == 97
    for res in ranks[name]:
        assert res[what].shape == want.shape
        np.testing.assert_allclose(res[what], want, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shards_hold_a_head_group_and_padded_vocab_rows(jax_side, ranks,
                                                        name):
    cfg = jax_side[name]["cfg"]
    whole = jax_side[name]["params"]["token_embedding"]
    for rank, res in enumerate(ranks[name]):
        emb = res["embedding"]
        assert emb.shape == (49, cfg["dim"])
        np.testing.assert_array_equal(emb[: 97 - 49 * rank],
                                      whole[49 * rank: 49 * rank + 49])
        if rank == 1:
            assert not emb[-1].any()  # the pad row
        heads = cfg["num_heads"] // 2
        assert res["cache"]["k"][2] == res["cache"]["cross_k"][2] == heads
        assert res["cache"]["cross_bias"] == (2, 1, 1, 6)


def test_refusals_match_jax(devices):
    cfg = t5.tiny_t5(device="cpu").cfg
    jcfg = jtiny_t5().cfg
    with pytest.raises(ValueError) as err:
        t5.SpmdT5(cfg, mesh=None)
    with pytest.raises(ValueError) as jerr:
        JSpmdT5(jcfg, mesh=None)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError) as err:
        t5.spmd_t5(mesh.make_mesh({"model": 8}, [torch.device("cpu")] * 8),
                   cfg)
    with pytest.raises(ValueError) as jerr:
        jspmd_t5(jmake_mesh({"model": 8}, devices), jcfg)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError) as err:
        t5.SpmdT5(cfg, mesh=mesh.make_mesh({"data": 1},
                                           [torch.device("cpu")]))
    with pytest.raises(ValueError) as jerr:
        JSpmdT5(jcfg, mesh=jmake_mesh({"data": 1}, devices[:1]))
    assert str(err.value) == str(jerr.value)


def test_one_process_size1_mesh_matches_t5():
    """A {"model": 1} mesh in one process: every collective the
    identity, so SpmdT5's tokens and logits are T5's exactly."""
    single = t5.tiny_t5(device="cpu", vocab_size=97)
    params = single.init(torch.Generator().manual_seed(0))
    enc, dec, mask = (torch.from_numpy(a).long() for a in _inputs())
    tp = t5.spmd_t5(mesh.make_mesh({"model": 1}, [torch.device("cpu")]),
                    single.cfg, compute_dtype=torch.float32)
    sp = tp.shard_params(params)
    torch.testing.assert_close(tp.forward(sp, enc, dec, enc_mask=mask),
                               single.forward(params, enc, dec,
                                              enc_mask=mask),
                               rtol=0, atol=0)
    assert torch.equal(tp.generate(sp, enc, STEPS),
                       single.generate(params, enc, STEPS))
