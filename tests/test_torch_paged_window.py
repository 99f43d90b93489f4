"""The port's paged decode windows (PagedDecodeServer(decode_window=K))
against the JAX package's and against the port's own decode_window=1.

The same weights (the JAX package's init, carried over with
`params_from_jax`) and the same prompts go through `defer_tpu`'s
`serve_paged(decode_window=K)` and the port's, in float32 on the CPU,
where the port's window body runs eagerly (tests/test_torch_cuda.py
holds the captured CUDA graph to it). Greedy outputs must be
token-identical across packages and across K, over attention x
prefix_cache x {fp, int8} pools, and the dispatch and KV-row accounting
equal (the port's "pallas" mode runs its kernels' plain versions, the
JAX package's blockwise fold, so it is held against JAX "blockwise",
whose batch-wide fold reads at least as many rows). A sampled slot's
stream must equal its own decode_window=1 stream in the sort and the
sort-free modes (torch and JAX generators differ). Eos mid-window,
budgets, stop sequences across windows and the streaming order must be
the K=1 loop's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu import obs as jax_obs
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import obs, params_from_jax
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged

CPU = torch.device("cpu")
JAX = {"gpt": jax_tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}
# Requests 0, 1 and 4 share their first full blocks at block_size 4.
PROMPTS = [([3, 9, 27, 4, 1, 8, 2, 6, 5], 7),
           ([3, 9, 27, 4, 1, 8, 2, 6, 11, 2], 4),
           ([11, 2, 8, 1, 6], 9), ([4, 4], 2), ([3, 9, 27, 4, 7], 5)]
KNOBS = dict(num_blocks=20, block_size=4, max_batch=2)
ROWS_READ = 'defer_kv_rows_read_total{server="paged"}'
ROWS_BASE = 'defer_kv_rows_gathered_baseline_total{server="paged"}'

_jax_runs: dict = {}


def _make(family):
    jdec = JAX[family](64)
    jparams = jdec.init(jax.random.key(0))
    return (PORT[family](64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


@pytest.fixture(scope="module")
def models():
    return {"gpt": _make("gpt"), "llama": _make("llama")}


def _requests(vocab):
    return [(torch.tensor([p]) % vocab, s) for p, s in PROMPTS]


def _port(model, reqs, **knobs):
    dec, params, _, _ = model
    with obs.counter_deltas() as d:
        outs, stats = serve_paged(dec, params, reqs, **knobs)
    return outs, stats, d


def _jax(model, family, reqs, **knobs):
    """The JAX package's run, memoized per knobs across the module."""
    key = (family, repr(sorted(knobs.items())))
    if key not in _jax_runs:
        _, _, jdec, jparams = model
        jreqs = [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in reqs]
        with jax_obs.counter_deltas() as d:
            outs, stats = jax_serve_paged(jdec, jparams, jreqs, **knobs)
        _jax_runs[key] = ([np.asarray(o) for o in outs], stats, d)
    return _jax_runs[key]


def _same(outs, want, msg=""):
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=msg)


@pytest.mark.parametrize(
    "K,attention,prefix_cache,kv_dtype",
    [c for c in itertools.product([2, 4], ["gathered", "pallas"],
                                  [False, True], ["fp", "int8"])
     if not (c[3] == "int8" and not c[2])],
)
def test_window_matches_jax_and_k1(models, K, attention, prefix_cache,
                                   kv_dtype):
    family = "llama" if attention == "pallas" else "gpt"
    model = models[family]
    reqs = _requests(model[0].cfg.vocab_size)
    knobs = dict(KNOBS, prefix_cache=prefix_cache, kv_dtype=kv_dtype,
                 prefill_chunk=3 if prefix_cache else None)
    outs, stats, d = _port(model, reqs, attention=attention,
                           decode_window=K, **knobs)
    k1, _, _ = _port(model, reqs, attention=attention, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats, jd = _jax(model, family, reqs, attention=jatt,
                             decode_window=K, **knobs)
    msg = f"K={K} {attention} prefix_cache={prefix_cache} {kv_dtype}"
    _same(outs, k1, msg)
    _same(outs, jouts, msg)
    for key in ("ticks", "host_dispatches", "tokens_per_dispatch",
                "peak_blocks", "prefill_tokens_saved", "decode_window"):
        assert stats[key] == jstats[key], (key, msg)
    assert stats["host_dispatches"] < sum(s for _, s in reqs)
    assert d[ROWS_BASE] == jd[ROWS_BASE]
    if attention == "pallas":
        assert 0 < d[ROWS_READ] <= jd[ROWS_READ]
    else:
        assert d[ROWS_READ] == jd[ROWS_READ]
    # A CPU server runs the body eagerly: no graph.
    assert stats["graph_replays"] == 0


def test_blockwise_window_matches_jax(models):
    """The plain "blockwise" fold in a window reads the table's whole
    span (a host bound cannot move inside a captured graph); the extra
    columns are fully masked, so the tokens stay JAX's and K=1's."""
    model = models["llama"]
    reqs = _requests(model[0].cfg.vocab_size)
    knobs = dict(KNOBS, attention="blockwise", prefix_cache=True,
                 prefill_chunk=3)
    outs, stats, _ = _port(model, reqs, decode_window=4, **knobs)
    jouts, jstats, _ = _jax(model, "llama", reqs, decode_window=4, **knobs)
    _same(outs, jouts)
    _same(outs, _port(model, reqs, **knobs)[0])
    assert stats["host_dispatches"] == jstats["host_dispatches"]


@pytest.mark.parametrize("sort", [False, True])
def test_sampled_window_equals_k1(models, sort):
    """Sampled slots (with top_k/top_p: the sorting draw; min_p only:
    the sort-free one) beside a greedy one: K=4 draws each slot's
    uniforms from its own generator in K=1's order."""
    dec, params, _, _ = models["llama"]
    reqs = _requests(dec.cfg.vocab_size)[:3]
    samps = [SamplingParams(temperature=0.9, top_k=20 if sort else 0,
                            min_p=0.0 if sort else 0.05, seed=7), None,
             SamplingParams(temperature=1.2, top_p=0.9 if sort else 1.0,
                            seed=3)]
    runs = []
    for K in (1, 4):
        outs, _ = serve_paged(dec, params, reqs, sampling=samps,
                              attention="pallas", prefix_cache=True,
                              prefill_chunk=3, decode_window=K, **KNOBS)
        runs.append(outs)
    _same(runs[1], runs[0])


def test_eos_budgets_stops_and_streaming_across_windows(models):
    """Eos mid-window ends its request there (JAX's tokens); a stop
    sequence that spans two windows cuts at its end, the overshoot
    dropped; budgets that end mid-window finish; the streamed tokens
    arrive in K=1's order with one `done` per request."""
    model = models["gpt"]
    dec, params, _, _ = model
    reqs = _requests(dec.cfg.vocab_size)
    free = dec.generate(params, reqs[0][0], reqs[0][1])
    eos = int(free[0, reqs[0][0].shape[1] + 2])
    knobs = dict(KNOBS, attention="pallas", prefix_cache=True)
    outs, _, _ = _port(model, reqs, eos_id=eos, decode_window=4, **knobs)
    jouts, _, _ = _jax(model, "gpt", reqs, eos_id=eos, decode_window=4,
                       **dict(knobs, attention="blockwise"))
    _same(outs, jouts)
    _same(outs, _port(model, reqs, eos_id=eos, **knobs)[0])
    assert outs[0].shape[1] < free.shape[1] and outs[0][0, -1] == eos

    prompt = reqs[2][0]
    full = dec.generate(params, prompt, 9)[0]
    gen = full[prompt.shape[1]:]
    stop = [int(gen[3]), int(gen[4])]  # spans windows 0 and 1 at K=4
    streams = []
    for K in (1, 4):
        events = []
        srv = PagedDecodeServer(
            dec, params, decode_window=K, attention="pallas",
            on_token=lambda rid, tok, done: events.append((rid, tok, done)),
            **KNOBS)
        r_stop = srv.submit(prompt, 9, stop=[stop])
        r_free = srv.submit(prompt, 9)
        r_short = srv.submit(reqs[3][0], 3)
        done = srv.run()
        streams.append(events)
        got = done[r_stop][0]
        first_end = next(j for j in range(1, len(gen))
                         if gen[j - 1:j + 1].tolist() == stop)
        assert len(got) == prompt.shape[1] + first_end + 1
        torch.testing.assert_close(got, full[: len(got)], rtol=0, atol=0)
        torch.testing.assert_close(done[r_free][0], full, rtol=0, atol=0)
        assert done[r_short].shape[1] == reqs[3][0].shape[1] + 3
        for rid in (r_stop, r_free, r_short):
            mine = [(t, d) for r, t, d in events if r == rid]
            assert [t for t, _ in mine] == done[rid][0, -len(mine):].tolist()
            assert [d for _, d in mine].count(True) == 1 and mine[-1][1]
        assert srv.blocks_in_use == 0 and sorted(srv.free) == list(
            range(1, 20))
    assert streams[0] == streams[1]
