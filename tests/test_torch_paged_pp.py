"""Pipeline-parallel paged serving in the port (PagedDecodeServer
pp_stages=S, runtime/paged.py `_PPLocalStage`, `_PPTransportStage`,
`_tick_pp`; runtime/remote_stage.py `serve_pp_stage`) against the JAX
package's pp server (tests/test_paged_pp.py), the same numpy weights,
f32, stages on `pp_devices=[cpu]` (every stage on the one CPU device, as
`[cuda:0] * S` puts them on one card):

  * greedy tokens identical to the JAX pp server and to the JAX decoder's
    generate over the JAX test's MATRIX, with the same per-stage
    dispatch counts, bubble fraction, pool bytes and cut starts;
  * each stage owns a 1/S slice of the pool (their sum the whole
    pool's), every stage's dispatch counter advances equally and the
    occupancy vector gives the bubble;
  * explicit cuts and probed balance; balance_stage_cuts on skewed
    stacks equals the JAX package's;
  * a stage behind the framed transport (serve_pp_stage in a thread)
    gives the same tokens and exits on the STOP frame;
  * the constructor's refusals are the JAX package's, word for word;
    pp x tp on a one-process {"stage": 2, "model": 1} mesh serves the
    pp_stages=1 tokens;
  * sampled requests and the prefill kernel's plain version ("pallas")
    through the stages equal pp_stages=1.
"""

import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jtiny_gpt
from defer_tpu.parallel.pipeline import balance_stage_cuts as jbalance
from defer_tpu.runtime.paged import PagedDecodeServer as JPagedDecodeServer
from defer_tpu.runtime.paged import serve_paged as jserve_paged
from defer_tpu_torch import obs, params_from_jax
from defer_tpu_torch.models.gpt import GptDecoder, SamplingParams
from defer_tpu_torch.parallel import mesh
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.parallel.pipeline import balance_stage_cuts
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged
from defer_tpu_torch.runtime.remote_stage import serve_pp_stage
from defer_tpu_torch.runtime.transport import ArrayReceiver

CPU = torch.device("cpu")
GPT = dict(num_layers=4, dim=64, num_heads=4, ffn_dim=128, vocab_size=128,
           max_len=64, norm_style="pre")
KW = dict(num_blocks=16, block_size=4, max_batch=2)

# The JAX test's MATRIX: (attention, prefix_cache, window, chunk, S).
MATRIX = [
    ("gathered", False, 1, None, 2),
    ("blockwise", True, 8, None, 2),
    ("gathered", True, 8, None, 4),
    ("gathered", False, 1, 8, 2),
]


@pytest.fixture(scope="module")
def model():
    jdec = jtiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    dec = GptDecoder(ts.TransformerConfig(**GPT), compute_dtype=torch.float32,
                     device=CPU)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device=CPU)
    return jdec, jparams, dec, params


def _requests(vocab):
    rng = np.random.default_rng(3)
    base = rng.integers(1, vocab, size=(1, 6)).astype(np.int32)
    ext = rng.integers(1, vocab, size=(1, 4)).astype(np.int32)
    return [
        (base, 7),
        (np.concatenate([base, ext], axis=1), 5),
        (rng.integers(1, vocab, size=(1, 11)).astype(np.int32), 6),
    ]


def _port(reqs):
    return [(torch.from_numpy(p).long(), s) for p, s in reqs]


def _jax(reqs):
    return [(jnp.asarray(p), s) for p, s in reqs]


@pytest.fixture(scope="module")
def solo(model):
    jdec, jparams, _, _ = model
    reqs = _requests(GPT["vocab_size"])
    return reqs, [np.asarray(jdec.generate(jparams, jnp.asarray(p), s))
                  for p, s in reqs]


PP_STATS = ("pp_stages", "pp_stage_dispatches", "pp_stage_pool_bytes",
            "pp_cut_starts", "pp_inflight")


@pytest.mark.parametrize("attention,prefix_cache,window,chunk,s", MATRIX)
def test_pp_token_identical(model, solo, attention, prefix_cache, window,
                            chunk, s):
    jdec, jparams, dec, params = model
    reqs, want = solo
    knobs = dict(KW, attention=attention, prefix_cache=prefix_cache,
                 decode_window=window, prefill_chunk=chunk, pp_stages=s)
    outs, st = serve_paged(dec, params, _port(reqs), pp_devices=[CPU],
                           **knobs)
    jouts, jst = jserve_paged(jdec, jparams, _jax(reqs), **knobs)
    for i, (got, jgot, ref) in enumerate(zip(outs, jouts, want)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot),
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(got.numpy(), ref,
                                      err_msg=f"request {i}")
    for key in PP_STATS:
        assert st[key] == jst[key], key
    assert st["pp_bubble_fraction"] == pytest.approx(
        jst["pp_bubble_fraction"])
    assert 0.0 <= st["pp_bubble_fraction"] < 1.0


def test_pool_slices_and_stage_counters(model, solo):
    """Each stage owns a 1/S slice of the pool (their sum is the whole
    pool's bytes), every stage's labeled dispatch counter advances by
    the same amount, and the occupancy vector gives the bubble."""
    _, _, dec, params = model
    reqs, _ = solo
    kw = dict(KW, decode_window=8)
    _, st1 = serve_paged(dec, params, _port(reqs), **kw)
    with obs.counter_deltas() as d:
        _, st2 = serve_paged(dec, params, _port(reqs), pp_stages=2,
                             pp_devices=[CPU], **kw)
    assert st1["pp_stages"] == 1 and st1["pp_stage_pool_bytes"] == []
    bytes2 = st2["pp_stage_pool_bytes"]
    assert len(bytes2) == 2 and bytes2[0] == bytes2[1]
    assert sum(bytes2) == st1["pool_bytes"] == st2["pool_bytes"]
    disp = st2["pp_stage_dispatches"]
    assert len(disp) == 2 and disp[0] == disp[1] > 0
    for s in range(2):
        assert d[f'defer_pp_stage_dispatches_total{{stage="{s}"}}'] == disp[s]
    occ = st2["pp_stage_occupancy"]
    assert len(occ) == 2 and all(0.0 < o <= 1.0 for o in occ)
    assert st2["pp_bubble_fraction"] == pytest.approx(
        1.0 - sum(occ) / len(occ))


def test_explicit_cuts_and_probe_balance(model, solo):
    """Explicit pp_cuts are honored verbatim (a skewed 3 + 1 split still
    decodes the same tokens), and pp_balance="probe" picks cuts from the
    measured per-layer step cost."""
    _, _, dec, params = model
    reqs, want = solo
    outs, st = serve_paged(dec, params, _port(reqs), pp_stages=2,
                           pp_cuts=[0, 3], pp_devices=[CPU], **KW)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert st["pp_cut_starts"] == [0, 3]
    outs, st = serve_paged(dec, params, _port(reqs), pp_stages=2,
                           pp_balance="probe", pp_devices=[CPU], **KW)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    starts = st["pp_cut_starts"]
    assert starts[0] == 0 and len(starts) == 2
    assert 0 < starts[1] < dec.cfg.num_layers


@pytest.mark.parametrize("costs,stages", [
    ([1.0] * 4, 2), ([4.0, 1.0, 1.0, 1.0], 2), ([1.0, 1.0, 1.0, 4.0], 2),
    ([3.0, 1.0, 1.0, 1.0, 1.0, 3.0], 3), ([2.0, 5.0, 1.0, 1.0, 7.0], 4),
])
def test_balance_cuts_on_skewed_stack(costs, stages):
    """The min-max split behind pp_balance="probe" cuts a skewed stack by
    cost, not layer count, as the JAX package's does."""
    assert balance_stage_cuts(costs, stages) == jbalance(costs, stages)


def test_transport_stage_parity(model, solo):
    """Stage 1 behind a serve_pp_stage worker reached over the wire, the
    controller keeping stage 0: the tokens do not move, and the worker
    exits on the STOP frame with the microbatches it served."""
    _, _, dec, params = model
    reqs, want = solo
    results = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=60.0)
    ports: queue.Queue = queue.Queue()
    served: list = []
    worker = threading.Thread(
        target=lambda: served.append(serve_pp_stage(
            dec, params, 2, 4, num_blocks=16, block_size=4,
            attention="gathered", listen_port=0, listen_host="127.0.0.1",
            result_host="127.0.0.1", result_port=results.port,
            accept_timeout_s=60.0, announce=ports.put)),
        daemon=True,
    )
    worker.start()
    try:
        port = ports.get(timeout=30)
        outs, st = serve_paged(
            dec, params, _port(reqs), pp_stages=2, pp_cuts=[0, 2],
            pp_devices=[CPU], pp_remote={1: ("127.0.0.1", port, results)},
            **KW)
        for got, ref in zip(outs, want):
            np.testing.assert_array_equal(got.numpy(), ref)
        assert st["pp_stage_dispatches"][1] > 0
        worker.join(timeout=30)
        assert not worker.is_alive(), "worker did not exit on STOP"
        assert served == [st["pp_stage_dispatches"][1]]
    finally:
        results.close()


def _ctor_refusals(dec, params, jdec, jparams):
    kw = dict(num_blocks=8, block_size=4, max_batch=2)
    return [
        (dict(pp_cuts=[0, 2], **kw), dict(pp_cuts=[0, 2], **kw)),
        (dict(pp_stages=8, **kw), dict(pp_stages=8, **kw)),
        (dict(pp_stages=2, spec_draft=dec, spec_params=params, spec_k=2,
              **kw),
         dict(pp_stages=2, spec_draft=jdec, spec_params=jparams, spec_k=2,
              **kw)),
        (dict(num_blocks=8, block_size=4, max_batch=3, pp_stages=2,
              pp_inflight=2),
         dict(num_blocks=8, block_size=4, max_batch=3, pp_stages=2,
              pp_inflight=2)),
        (dict(pp_stages=2, device=CPU, **kw),
         dict(pp_stages=2, device=jax.devices()[0], **kw)),
        (dict(pp_stages=2, kv_dtype="int8", **kw),
         dict(pp_stages=2, kv_dtype="int8", **kw)),
        (dict(pp_stages=2, prefill_budget=4, **kw),
         dict(pp_stages=2, prefill_budget=4, **kw)),
        (dict(pp_stages=2, pp_cuts=[0, 9], pp_devices=[CPU], **kw),
         dict(pp_stages=2, pp_cuts=[0, 9], **kw)),
    ]


def test_pp_ctor_validation(model):
    """Every bad composition is refused at construction with the JAX
    package's words (and its Fix: hints); disagg ingest is refused on a
    pp server."""
    jdec, jparams, dec, params = model
    for ours, theirs in _ctor_refusals(dec, params, jdec, jparams):
        with pytest.raises(ValueError) as err:
            PagedDecodeServer(dec, params, **ours)
        with pytest.raises(ValueError) as jerr:
            JPagedDecodeServer(jdec, jparams, **theirs)
        assert str(err.value) == str(jerr.value), ours
    srv = PagedDecodeServer(dec, params, pp_stages=2, pp_devices=[CPU],
                            num_blocks=8, block_size=4, max_batch=2)
    jsrv = JPagedDecodeServer(jdec, jparams, pp_stages=2, num_blocks=8,
                              block_size=4, max_batch=2)
    with pytest.raises(ValueError, match="disagg ingest") as err:
        srv.submit_prefilled(torch.tensor([[1, 2, 3]]), 4)
    with pytest.raises(ValueError) as jerr:
        jsrv.submit_prefilled(jnp.asarray([[1, 2, 3]], jnp.int32), 4)
    assert str(err.value) == str(jerr.value)


def test_pp_x_tp_raises_naming_its_item(model, solo):
    """pp x tp (mesh= with pp_stages > 1): a mesh without the stage axis
    is refused as the JAX package refuses it; a one-process
    {"stage": 2, "model": 1} mesh splits into one submesh a stage
    (stage_submeshes) and serves the pp_stages=1 server's tokens (the
    JAX test's point; tp > 1 runs over ranks, tests/test_torch_paged_mesh.py)."""
    _, _, dec, params = model
    with pytest.raises(ValueError, match="needs a 'stage' mesh axis"):
        PagedDecodeServer(dec, params, pp_stages=2, mesh=mesh.make_mesh(
            {"model": 1}, [CPU]), **KW)
    reqs, want = solo
    outs, st = serve_paged(dec, params, _port(reqs), pp_stages=2,
                           mesh=mesh.make_mesh({"stage": 2, "model": 1},
                                               [CPU] * 2), **KW)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert st["pp_stages"] == 2 and st["tp_psums"] > 0
    assert st["mesh_shape"] == "model=1"


@pytest.mark.parametrize("attention", ["pallas", "blockwise"])
def test_sampled_and_pallas_match_pp1(model, solo, attention):
    """Sampled requests (each slot's own generator, uniforms drawn a
    window ahead) and greedy ones through 2 stages at K = 4 and 2
    microbatch groups equal the pp_stages=1 server's tokens."""
    _, _, dec, params = model
    reqs, _ = solo
    samp = [SamplingParams(temperature=0.8, top_k=20, seed=7), None,
            SamplingParams(temperature=1.1, min_p=0.05, seed=3)]
    kw = dict(KW, attention=attention, decode_window=4, sampling=samp)
    outs1, _ = serve_paged(dec, params, _port(reqs), **kw)
    outs2, st = serve_paged(dec, params, _port(reqs), pp_stages=2,
                            pp_inflight=2, pp_devices=[CPU], **kw)
    for a, b in zip(outs1, outs2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert st["pp_inflight"] == 2
