"""The port's SpmdGptDecoder (defer_tpu_torch/models/gpt.py, over a gloo
process group of CPU ranks) against the JAX package's SpmdGptDecoder on
its virtual CPU devices, the same numpy weights through both, f32.

One spawn of 4 ranks (tests/test_torch_dist_worker.py, which never
imports jax) runs every case on a {"data": 2, "model": 2} mesh: tp 2
with the data axis replicated (a GPT with learned positions, layer norm
and a vocab of 49 that tp pads to 50; a llama with GQA on an int8
weight-only tree), and dp 2 x tp 2 (the cache's batch rows over
"data"). Stated tolerances: the prefill step's and each decode step's
logits rtol / atol 1e-4 against the JAX step's (the same math, the tp
partial sums added in another order); each rank's cache shard against
the matching slice of the JAX cache, the same; greedy tokens identical
(`generate`, and serve_greedy on the flat DecodeServer with the same
submits on every rank against the JAX decoder's own generate). The
validation errors are the JAX package's, word for word.

The JAX package reaches shard_map through `defer_tpu/utils/compat.py`,
whose positional `mesh` the installed jax (0.9) refuses; `jax_shard_map`
puts a keyword-mesh shim in its place while the JAX side runs (the JAX
package itself is unchanged).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models import quant as jquant
from defer_tpu.models.gpt import GptDecoder as JGptDecoder
from defer_tpu.models.gpt import SpmdGptDecoder as JSpmdGptDecoder
from defer_tpu.models.llama import llama_config as jllama_config
from defer_tpu.models.llama import spmd_llama as jspmd_llama
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.gpt import GptDecoder, SpmdGptDecoder
from defer_tpu_torch.models.llama import llama_config, spmd_llama
from defer_tpu_torch.parallel import mesh
from defer_tpu_torch.parallel import transformer_stack as ts
from test_torch_dist_worker import spawn

TOL = dict(rtol=1e-4, atol=1e-4)
AXES = {"data": 2, "model": 2}
GPT = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=49,
           max_len=16, norm_style="pre")
LLAMA = dict(num_layers=2, dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
             vocab_size=64, max_len=24)
CPU = torch.device("cpu")


@contextlib.contextmanager
def jax_shard_map():
    """defer_tpu.utils.compat.shard_map as the installed jax takes it."""
    from defer_tpu.utils import compat

    def shim(f, mesh, *, in_specs, out_specs, check_rep=True):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=check_rep)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compat, "shard_map", shim)
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = {
    # name: (config kwargs, llama, int8, dp, batch)
    "gpt_tp2_vocab49": (GPT, False, False, False, 2),
    "llama_tp2_int8": (LLAMA, True, True, False, 2),
    "gpt_dp2_tp2": (dict(GPT, vocab_size=64), False, False, True, 4),
}


def decode_case(devices, name):
    cfg_kw, llama, int8, dp, batch = CASES[name]
    jcfg = (jllama_config if llama else jts.TransformerConfig)(**cfg_kw)
    ref = JGptDecoder(jcfg, compute_dtype=jnp.float32)
    params = ref.init(jax.random.key(0))
    if int8:
        params = jquant.quantize_decoder_params(params)
    axes = AXES if dp else {"model": 2}
    jdec = JSpmdGptDecoder(
        jcfg, compute_dtype=jnp.float32,
        mesh=jmesh.make_mesh(axes, devices[: 4 if dp else 2]),
        dp_axis="data" if dp else None,
    )
    tparams = jdec.shard_params(params)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg_kw["vocab_size"], (batch, 8)).astype(np.int32)
    t0 = 5
    step = jdec.make_step(donate=False)
    logits, cache = step(tparams, jdec.init_cache(batch),
                         jnp.asarray(ids[:, :t0]))
    want = {"prefill": np.asarray(logits)}
    steps = []
    for t in range(t0, ids.shape[1]):
        logits, cache = step(tparams, cache, jnp.asarray(ids[:, t:t + 1]))
        steps.append(np.asarray(logits[:, 0]))
    want["steps"] = np.stack(steps, axis=1)
    want["k"], want["v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    want["generate"] = np.asarray(
        jdec.generate(tparams, jnp.asarray(ids[:, :3]), 5))
    requests = None
    if name == "gpt_tp2_vocab49":
        requests = [(rng.integers(1, 49, (1, n)).astype(np.int32), s)
                    for n, s in ((4, 6), (7, 3), (2, 8))]
        want["served"] = [np.asarray(ref.generate(params, jnp.asarray(p), s))
                          for p, s in requests]
    case = dict(name=name, run="decode", axes=AXES, cfg=cfg_kw, llama=llama,
                params=_np(params), ids=ids, t0=t0, generate=(3, 5),
                dp_axis="data" if dp else None, requests=requests)
    return case, want


@pytest.fixture(scope="module")
def world4(devices, tmp_path_factory):
    cases, wants = [], {}
    for name in CASES:
        with jax_shard_map():
            case, want = decode_case(devices, name)
        cases.append(case)
        wants[name] = want
    results = spawn({"cases": cases}, 4,
                    str(tmp_path_factory.mktemp("spmd_decode")))
    return results, wants


def _shard_of(whole, rank, dp):
    """The slice of a whole [L, B, Hkv, S, Dh] cache rank `rank` of the
    {"data": 2, "model": 2} mesh holds."""
    d, m = np.unravel_index(rank, (2, 2))
    b = whole.shape[1] // (2 if dp else 1)
    h = whole.shape[2] // 2
    rows = slice(d * b, (d + 1) * b) if dp else slice(None)
    return whole[:, rows, m * h:(m + 1) * h]


@pytest.mark.parametrize("name", list(CASES))
def test_step_logits_and_cache_shards_match_jax(world4, name):
    results, wants = world4
    want = wants[name]
    dp = CASES[name][3]
    for rank, res in enumerate(results):
        got = res[name]
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["steps"], want["steps"], **TOL,
                                   err_msg=f"rank {rank}")
        for key in ("k", "v"):
            np.testing.assert_allclose(
                got[key], _shard_of(want[key], rank, dp), **TOL,
                err_msg=f"rank {rank} cache {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_generate_is_token_identical(world4, name):
    results, wants = world4
    for res in results:
        np.testing.assert_array_equal(res[name]["generate"],
                                      wants[name]["generate"])


def test_decode_server_over_tp_decoder(world4):
    """The flat DecodeServer at K=1 over the tp decoder, the same submits
    on every rank: each request's tokens are the plain decoder's."""
    results, wants = world4
    for res in results:
        for got, want in zip(res["gpt_tp2_vocab49"]["served"],
                             wants["gpt_tp2_vocab49"]["served"]):
            np.testing.assert_array_equal(got, want)


def test_vocab_pads_to_a_tp_multiple():
    """On a size-1 mesh in one process (every collective the identity)
    the step is the plain decoder's: logits and tokens equal, the table
    not padded at tp 1."""
    cfg = ts.TransformerConfig(**GPT)
    ref = GptDecoder(cfg, compute_dtype=torch.float32, device="cpu")
    params = ref.init(torch.Generator().manual_seed(0))
    one = mesh.make_mesh({"model": 1}, [CPU])
    tp = SpmdGptDecoder(cfg, compute_dtype=torch.float32, mesh=one)
    tparams = tp.shard_params(params)
    assert tparams["token_embedding"].shape == (49, 32)
    ids = torch.randint(0, 49, (2, 6), generator=torch.Generator()
                        .manual_seed(1))
    torch.testing.assert_close(tp.reference_logits(tparams, ids),
                               ref.reference_logits(params, ids),
                               rtol=0, atol=0)
    assert torch.equal(tp.generate(tparams, ids[:, :3], 5),
                       ref.generate(params, ids[:, :3], 5))


def _refusals(devices):
    cfg = dict(num_layers=2, dim=64, num_heads=4, ffn_dim=128, vocab_size=64,
               max_len=16, norm_style="pre")
    cpu = [CPU] * 4
    return {
        "no_mesh": (
            lambda: SpmdGptDecoder(ts.TransformerConfig(**cfg), mesh=None),
            lambda: JSpmdGptDecoder(jts.TransformerConfig(**cfg), mesh=None),
        ),
        "indivisible_tp": (
            lambda: SpmdGptDecoder(ts.TransformerConfig(**cfg),
                                   mesh=mesh.make_mesh({"model": 3}, cpu)),
            lambda: JSpmdGptDecoder(
                jts.TransformerConfig(**cfg),
                mesh=jmesh.make_mesh({"model": 3}, devices[:3])),
        ),
        "kv_heads": (
            lambda: spmd_llama(mesh.make_mesh({"model": 4}, cpu),
                               llama_config(**LLAMA)),
            lambda: jspmd_llama(jmesh.make_mesh({"model": 4}, devices[:4]),
                                jllama_config(**LLAMA)),
        ),
        "dp_not_an_axis": (
            lambda: SpmdGptDecoder(ts.TransformerConfig(**cfg),
                                   mesh=mesh.make_mesh({"model": 2}, cpu),
                                   dp_axis="data"),
            lambda: JSpmdGptDecoder(
                jts.TransformerConfig(**cfg),
                mesh=jmesh.make_mesh({"model": 2}, devices[:2]),
                dp_axis="data"),
        ),
        "dp_is_tp": (
            lambda: SpmdGptDecoder(ts.TransformerConfig(**cfg),
                                   mesh=mesh.make_mesh({"model": 2}, cpu),
                                   dp_axis="model"),
            lambda: JSpmdGptDecoder(
                jts.TransformerConfig(**cfg),
                mesh=jmesh.make_mesh({"model": 2}, devices[:2]),
                dp_axis="model"),
        ),
    }


@pytest.mark.parametrize("site", ["no_mesh", "indivisible_tp", "kv_heads",
                                  "dp_not_an_axis", "dp_is_tp"])
def test_validation_errors_match_jax(devices, site):
    ours, theirs = _refusals(devices)[site]
    with pytest.raises(ValueError) as err:
        ours()
    with pytest.raises(ValueError) as jerr:
        theirs()
    assert str(err.value) == str(jerr.value)


def test_untied_head_and_one_process_tp_refuse(devices):
    """An untied lm_head raises as the JAX package's does; a model axis
    larger than 1 in one process raises naming multihost.initialize."""
    cfg = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
               max_len=16, norm_style="pre")
    one = SpmdGptDecoder(ts.TransformerConfig(**cfg), mesh=mesh.make_mesh(
        {"model": 1}, [CPU]), compute_dtype=torch.float32)
    jone = JSpmdGptDecoder(jts.TransformerConfig(**cfg),
                           mesh=jmesh.make_mesh({"model": 1}, devices[:1]),
                           compute_dtype=jnp.float32)
    head = {"lm_head": np.zeros((64, 32), np.float32),
            "stack": {}, "token_embedding": np.zeros((64, 32), np.float32)}
    with pytest.raises(NotImplementedError) as err:
        one.shard_params(params_from_jax(head, device=CPU))
    with pytest.raises(NotImplementedError) as jerr:
        jone.shard_params(head)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        SpmdGptDecoder(ts.TransformerConfig(**cfg), mesh=mesh.make_mesh(
            {"model": 2}, [CPU] * 2))
    with pytest.raises(NotImplementedError, match="decode_window > 1"):
        one.decode_step_fn()


def test_embed_lookup_tp_on_a_size1_axis_matches_jax(devices):
    """embed_lookup(tp_axis=) on a one-process size-1 model axis, plain
    and int8 tables, against the JAX package's under shard_map."""
    from jax.sharding import PartitionSpec as P

    from defer_tpu_torch.parallel import collectives

    rng = np.random.default_rng(0)
    table = rng.standard_normal((10, 6)).astype(np.float32)
    ids = rng.integers(0, 10, (2, 3)).astype(np.int32)
    jm = jmesh.make_mesh({"model": 1}, devices[:1])
    one = mesh.make_mesh({"model": 1}, [CPU])
    for tab in (table, _np(jquant.quantize_leaf(jnp.asarray(table)))):
        spec = ({"q": P("model", None), "s": P(None, None)}
                if isinstance(tab, dict) else P("model", None))
        want = jax.shard_map(
            lambda t, i: jts.embed_lookup(t, i, "model"), mesh=jm,
            in_specs=(spec, P()), out_specs=P())(tab, jnp.asarray(ids))
        with collectives.active(one):
            got = ts.embed_lookup(
                params_from_jax({"t": tab}, device=CPU)["t"],
                torch.from_numpy(ids).long(), "model")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
