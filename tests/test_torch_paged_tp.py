"""Tensor-parallel paged serving in the port: PagedDecodeServer(mesh=)
over a gloo process group of CPU ranks (tests/test_torch_dist_worker.py
"paged" cases, which never import jax), held to the JAX package's
contract for its `mesh=` server (tests/test_paged_tp.py):

  * greedy tokens identical to the JAX package's mesh=None serve_paged
    and to its decoder's own generate, over the JAX test's MATRIX
    (attention x prefix cache x window x spec x chunk, at tp 2 and 4);
  * stats["mesh_shape"] reads "model=tp"; tp_psums is (2L + 2) x the
    sharded forwards the ranks ran (each rank counts its `_final_logits`
    calls with a tp axis); a mesh window runs uncaptured (no replays);
  * per-shard KV rows are 1 / tp of mesh=None's and host dispatches are
    the same; a size-1 mesh is token-identical to mesh=None;
  * the kv-head refusals are the JAX package's, word for word;
  * disagg ingest, the spill tier and prefix migration (export and
    import) work under a mesh: full-head K/V lands split on its head
    axis, and leaves gathered whole;
  * after every run each rank's pool shard equals the matching head
    slice of the port's mesh=None pool for the same run (blocks past the
    trash block 0; atol / rtol 1e-4 in f32: the K/V projections are
    column slices and the psums add in another order; an int8 payload
    within one quantization step, its scales rtol 1e-4).

The ranks run the kernels' plain versions (CPU tensors). One spawn of 2
ranks serves every tp 2 case, one of 4 the tp 4 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jtiny_gpt
from defer_tpu.models.llama import tiny_llama as jtiny_llama
from defer_tpu.parallel import mesh as jmesh
from defer_tpu.runtime.paged import PagedDecodeServer as JPagedDecodeServer
from defer_tpu.runtime.paged import serve_paged as jserve_paged
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.constrain.dfa import compile_regex
from defer_tpu_torch.disagg.prefill_worker import run_prefill
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.parallel import mesh
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged
from test_torch_dist_worker import _paged, spawn

CPU = torch.device("cpu")
GPT = dict(num_layers=4, dim=64, num_heads=4, ffn_dim=128, vocab_size=128,
           max_len=64, norm_style="pre")
BASE = dict(num_blocks=16, block_size=4, max_batch=2)
TOL = dict(rtol=1e-4, atol=1e-4)
PSUMS = 2 * GPT["num_layers"] + 2
# Two sampled requests beside a greedy one (each slot's own generator).
SAMPLED = [dict(temperature=0.8, top_k=20, seed=7), None,
           dict(temperature=1.1, min_p=0.05, seed=3)]

# The JAX test's MATRIX: (attention, prefix_cache, window, spec_k,
# chunk, tp).
MATRIX = [
    ("gathered", False, 1, 0, None, 2),
    ("blockwise", True, 1, 0, None, 2),
    ("pallas", False, 1, 0, None, 2),
    ("gathered", False, 8, 0, None, 2),
    ("blockwise", False, 1, 4, None, 2),
    ("gathered", True, 1, 0, 8, 2),
    ("gathered", False, 8, 0, None, 4),
    ("blockwise", False, 1, 0, None, 4),
]


def _mid(point):
    return "-".join(str(v) for v in point)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    dec = jtiny_gpt(64)
    params = dec.init(jax.random.key(0))
    draft = dec.init(jax.random.key(7))
    return dec, params, draft


def _requests(vocab):
    """The JAX test's requests: a shared prefix on the first two, one
    prompt that prefill_chunk=8 splits."""
    rng = np.random.default_rng(3)
    base = rng.integers(1, vocab, size=(1, 6)).astype(np.int32)
    ext = rng.integers(1, vocab, size=(1, 4)).astype(np.int32)
    return [
        (base, 7),
        (np.concatenate([base, ext], axis=1), 5),
        (rng.integers(1, vocab, size=(1, 11)).astype(np.int32), 6),
    ]


def _spill_phases(vocab):
    """A prefix warm-up, pool-thrashing fillers, then the same prefix
    again (tests/test_torch_kv_quant.py's spill workload)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, vocab, size=(1, 8))
    ta, tb = (rng.integers(1, vocab, size=(1, n)) for n in (3, 2))
    fillers = [rng.integers(1, vocab, size=(1, 9)) for _ in range(3)]
    return ([[(np.concatenate([prefix, ta], axis=1), 4)]]
            + [[(f, 6)] for f in fillers]
            + [[(np.concatenate([prefix, tb], axis=1), 5)]])


def _vocab():
    """tests/test_torch_paged_constrain_lora.py's token strings, 128."""
    chars = list("0123456789abcdefghijklmnopqrstuvwxyz{}[]\",:.- eE+")
    vocab = [""] + chars + ["ab", "12", '":', "},"]
    return vocab + [f"<u{i}>" for i in range(128 - len(vocab))]


def _case(name, tp, params, knobs, phases, **extra):
    return dict(name=name, run="paged", axes={"model": tp}, cfg=GPT,
                params=params, knobs=dict(BASE, **knobs), phases=phases,
                **extra)


def _matrix_case(point, params, draft):
    attention, prefix_cache, window, spec_k, chunk, tp = point
    knobs = dict(attention=attention, prefix_cache=prefix_cache,
                 decode_window=window, prefill_chunk=chunk)
    extra = {}
    if spec_k:
        knobs["spec_k"] = spec_k
        extra["draft"] = draft
    return _case(_mid(point), tp, params, knobs,
                 [_requests(GPT["vocab_size"])], **extra)


@pytest.fixture(scope="module")
def cases(model):
    dec, jparams, jdraft = model
    params, draft = _np(jparams), _np(jdraft)
    out = {_mid(p): _matrix_case(p, params, draft) for p in MATRIX}
    prompt = np.asarray([[3, 9, 27, 5, 11]], np.int32)
    port_dec = GptDecoder(ts.TransformerConfig(**GPT),
                          compute_dtype=torch.float32, device=CPU)
    k, v, lg = run_prefill(port_dec, params_from_jax(params, device=CPU),
                           prompt, block_size=4)
    reqs = _requests(GPT["vocab_size"])
    more = np.concatenate([reqs[1][0], [[7]]], axis=1).astype(np.int32)
    out.update(
        int8=_case("int8", 2, params, dict(attention="pallas",
                                           kv_dtype="int8"), [reqs]),
        disagg=_case("disagg", 2, params, {}, [[]], delivered=[[
            (prompt, 6, k.numpy(), v.numpy(), lg.numpy())]]),
        spill=_case("spill", 2, params, dict(
            num_blocks=10, max_batch=1, prefix_cache=True,
            spill_bytes=1 << 20), _spill_phases(GPT["vocab_size"])),
        migrate=_case("migrate", 2, params, dict(prefix_cache=True),
                      [[reqs[1]]], migrate=dict(prompt=reqs[1][0], blocks=2,
                                                request=(more, 4))),
        mixed=_case("mixed", 2, params, dict(prefill_budget=4), [reqs],
                    sampling=SAMPLED),
        spec_window=_case("spec_window", 2, params, dict(
            attention="pallas", spec_k=2, decode_window=4), [reqs],
            draft=draft),
        constrained=_case("constrained", 2, params, dict(
            eos_id=0, decode_window=4,
            constraints={"digits": compile_regex("[0-9]+", _vocab())}),
            [reqs], sampling=[{"constraint": "digits"},
                              {"constraint": "digits", "temperature": 0.9,
                               "seed": 5}, None]),
    )
    return out


def _spawn(cases, tp, tmp_path_factory):
    chosen = [c for c in cases.values() if c["axes"]["model"] == tp]
    ranks = spawn({"cases": chosen}, tp,
                  str(tmp_path_factory.mktemp(f"paged_tp{tp}")))
    return {c["name"]: [r[c["name"]] for r in ranks] for c in chosen}


@pytest.fixture(scope="module")
def served(cases, tmp_path_factory):
    """Every case's per-rank results, and the port's mesh=None run of
    the same case in this process."""
    got = {**_spawn(cases, 2, tmp_path_factory),
           **_spawn(cases, 4, tmp_path_factory)}
    return got, {name: _paged(case, None) for name, case in cases.items()}


@pytest.fixture(scope="module")
def solo(model):
    dec, params, _ = model
    return [np.asarray(dec.generate(params, jnp.asarray(p), s))
            for p, s in _requests(GPT["vocab_size"])]


@pytest.mark.parametrize("point", MATRIX, ids=_mid)
def test_tp_token_identical(model, solo, served, point):
    dec, params, draft = model
    attention, prefix_cache, window, spec_k, chunk, tp = point
    spec = (dict(spec_draft=dec, spec_params=draft, spec_k=spec_k)
            if spec_k else {})
    jouts, _ = jserve_paged(
        dec, params, [(jnp.asarray(p), s) for p, s in
                      _requests(GPT["vocab_size"])],
        attention=attention, prefix_cache=prefix_cache,
        decode_window=window, prefill_chunk=chunk, **BASE, **spec)
    ranks = served[0][_mid(point)]
    ctl = ranks[0]
    for i, (got, want, ref) in enumerate(zip(ctl["tokens"], jouts, solo)):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(got, ref, err_msg=f"request {i}")
    assert ctl["mesh_shape"] == f"model={tp}"
    assert ctl["tp_psums"] == PSUMS * ctl["forwards"] > 0
    assert all(r["forwards"] == ctl["forwards"] for r in ranks)
    assert ctl["graph_replays"] == 0


def _assert_shards(ranks, ref_pool, int8=False):
    tp = len(ranks)
    for rank, res in enumerate(ranks):
        for j, (got, whole) in enumerate(zip(res["pool"], ref_pool)):
            h = whole.shape[2] // tp
            want = whole[:, 1:, rank * h:(rank + 1) * h]
            got = got[:, 1:]
            if int8 and j % 2 == 0:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, f"rank {rank} leaf {j}"
            else:
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"rank {rank} leaf {j}")


@pytest.mark.parametrize("point", MATRIX, ids=_mid)
def test_pool_shards_match_mesh_none(served, point):
    got, ref = served
    _assert_shards(got[_mid(point)], ref[_mid(point)]["pool"])


def test_size1_mesh_matches_mesh_none(model, solo):
    """A one-process {"model": 1} mesh runs every program through the
    seam with its collectives the identity: tokens equal mesh=None's,
    and the psum mirror counts."""
    dec = GptDecoder(ts.TransformerConfig(**GPT), compute_dtype=torch.float32,
                     device=CPU)
    params = params_from_jax(_np(model[1]), device=CPU)
    reqs = [(torch.from_numpy(p).long(), s)
            for p, s in _requests(GPT["vocab_size"])]
    outs0, st0 = serve_paged(dec, params, reqs, **BASE)
    outs1, st1 = serve_paged(dec, params, reqs, **BASE,
                             mesh=mesh.make_mesh({"model": 1}, [CPU]))
    for a, b, ref in zip(outs0, outs1, solo):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), ref)
    assert st0["mesh_shape"] is None and st0["tp_psums"] == 0
    assert st1["mesh_shape"] == "model=1" and st1["tp_psums"] > 0


def test_kv_rows_scale_dispatches_do_not(served):
    """Per-shard KV reads halve at tp 2 while host dispatches do not
    move (the blockwise point of the matrix)."""
    got, ref = served
    name = _mid(("blockwise", True, 1, 0, None, 2))
    ctl, base = got[name][0], ref[name]
    assert base["kv_rows"] > 0 and ctl["kv_rows"] * 2 == base["kv_rows"]
    assert ctl["dispatches"] == base["dispatches"] > 0
    assert ctl["pool_bytes"] == base["pool_bytes"]


def test_kv_head_shard_errors(devices):
    """Both indivisibility refusals at construction, word for word the
    JAX package's, with their Fix: hints."""
    jdec = jtiny_llama(32)  # num_kv_heads=2
    jparams = jdec.init(jax.random.key(0))
    dec = tiny_llama(32, device="cpu")
    params = params_from_jax(_np(jparams), device=CPU)
    kw = dict(num_blocks=8, block_size=4, max_batch=2)
    with pytest.raises(ValueError, match="num_kv_heads=2 is smaller") as err:
        PagedDecodeServer(dec, params, mesh=mesh.make_mesh(
            {"model": 4}, [CPU] * 4), **kw)
    with pytest.raises(ValueError) as jerr:
        JPagedDecodeServer(jdec, jparams, mesh=jmesh.make_mesh(
            {"model": 4}, devices[:4]), **kw)
    assert str(err.value) == str(jerr.value)
    jdec4 = jtiny_gpt(32)  # MHA: 4 KV heads
    jparams4 = jdec4.init(jax.random.key(0))
    dec4 = GptDecoder(ts.TransformerConfig(**dict(GPT, max_len=32)),
                      compute_dtype=torch.float32, device=CPU)
    params4 = params_from_jax(_np(jparams4), device=CPU)
    with pytest.raises(ValueError, match="does not divide") as err:
        PagedDecodeServer(dec4, params4, mesh=mesh.make_mesh(
            {"model": 3}, [CPU] * 3), **kw)
    with pytest.raises(ValueError) as jerr:
        JPagedDecodeServer(jdec4, jparams4, mesh=jmesh.make_mesh(
            {"model": 3}, devices[:3]), **kw)
    assert str(err.value) == str(jerr.value)
    assert "Fix:" in str(err.value)


def test_mesh_refusals_in_one_process():
    """mesh= with device= and with multi-LoRA refuse as the JAX package
    does; a model axis > 1 in one process needs multihost.initialize."""
    dec = GptDecoder(ts.TransformerConfig(**GPT), compute_dtype=torch.float32,
                     device=CPU)
    params = dec.init(torch.Generator().manual_seed(0))
    one = mesh.make_mesh({"model": 1}, [CPU])
    with pytest.raises(ValueError, match="mutually exclusive"):
        PagedDecodeServer(dec, params, mesh=one, device=CPU, **BASE)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        PagedDecodeServer(dec, params, **BASE, mesh=mesh.make_mesh(
            {"model": 2}, [CPU] * 2))
    with pytest.raises(ValueError, match="plain single-device decoder"):
        from defer_tpu_torch.models.gpt import SpmdGptDecoder

        PagedDecodeServer(SpmdGptDecoder(dec.cfg, mesh=one,
                                         compute_dtype=torch.float32),
                          params, mesh=one, **BASE)


def test_int8_pool_under_mesh(served):
    """The int8 pool at K=1 through the paged decode kernel's plain
    version, sharded: tokens equal mesh=None's, payload within one step,
    scales within 1e-4."""
    got, ref = served
    for a, b in zip(got["int8"][0]["tokens"], ref["int8"]["tokens"]):
        np.testing.assert_array_equal(a, b)
    _assert_shards(got["int8"], ref["int8"]["pool"], int8=True)


def test_disagg_ingest_scatters_into_shards(model, served):
    """A prefill worker's full-head blob delivered to a meshed server
    lands split on its head axis: the tokens are the unmeshed server's
    and the plain decoder's, and so are the shards."""
    dec, params, _ = model
    got, ref = served
    want = np.asarray(dec.generate(
        params, jnp.asarray([[3, 9, 27, 5, 11]], jnp.int32), 6))
    np.testing.assert_array_equal(got["disagg"][0]["tokens"][0],
                                  ref["disagg"]["tokens"][0])
    np.testing.assert_array_equal(got["disagg"][0]["tokens"][0], want)
    _assert_shards(got["disagg"], ref["disagg"]["pool"])


def test_spill_revival_under_mesh(served):
    """Evicted prefix blocks gather whole into the controller's spill
    store and revive split over the ranks: tokens, spill hits and saved
    prefill equal mesh=None's."""
    got, ref = served
    ctl, base = got["spill"][0], ref["spill"]
    for a, b in zip(ctl["tokens"], base["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert ctl["spill_hits"] == base["spill_hits"] > 0
    assert ctl["saved"] == base["saved"] > 0
    _assert_shards(got["spill"], base["pool"])


def test_prefix_migration_under_mesh(model, served):
    """export_prefix_blocks gathers every head (equal to mesh=None's
    export); import_prefix_blocks splits them, and the request sharing
    the chain skips its prefill and decodes the plain decoder's tokens."""
    dec, params, _ = model
    got, ref = served
    ctl, base = got["migrate"][0], ref["migrate"]
    toks, k, v = ctl["export"]
    assert toks == base["export"][0]
    np.testing.assert_allclose(k, base["export"][1], **TOL)
    np.testing.assert_allclose(v, base["export"][2], **TOL)
    assert ctl["imported"] == base["imported"] == 2
    reqs = _requests(GPT["vocab_size"])
    more = np.concatenate([reqs[1][0], [[7]]], axis=1)
    want = np.asarray(dec.generate(params, jnp.asarray(more, jnp.int32), 4))
    np.testing.assert_array_equal(ctl["migrated"], want)
    assert ctl["migrated_saved"] == base["migrated_saved"] == 8
    _assert_shards(got["migrate"], base["pool"])


@pytest.mark.parametrize("name", ["mixed", "spec_window", "constrained"])
def test_mixed_ticks_and_spec_windows_under_mesh(model, served, solo, name):
    """prefill_budget mixed ticks (two sampled requests beside a greedy
    one: the controller samples from the gathered logits), speculative
    windows (spec_k 2, 4 rounds a dispatch, the draft on the controller
    alone) and constrained windows (a digits regex, greedy and sampled,
    eos 0) under a tp 2 mesh: tokens equal the port's mesh=None run's,
    unconstrained greedy ones the plain decoder's, and the pool shards
    equal mesh=None's."""
    got, ref = served
    ctl = got[name][0]
    for a, b in zip(ctl["tokens"], ref[name]["tokens"]):
        np.testing.assert_array_equal(a, b)
    greedy = {"mixed": [1], "spec_window": [0, 1, 2]}.get(name, [])
    for i in greedy:
        np.testing.assert_array_equal(ctl["tokens"][i], solo[i])
    assert ctl["tp_psums"] == PSUMS * ctl["forwards"] > 0
    _assert_shards(got[name], ref[name]["pool"])
