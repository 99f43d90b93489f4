"""The port's decode windows (DecodeServer(decode_window=K)) against the
JAX package's and against the port's own decode_window=1.

The same weights (the JAX package's init, carried over with
`params_from_jax`) and the same prompts go through
`defer_tpu.runtime.decode_server.serve_greedy(decode_window=K)` and the
port's. Greedy outputs must be token-identical across packages and
across K; a sampled slot's stream must equal its own decode_window=1
stream (torch and JAX generators differ, so sampled tokens are not
compared across packages). On the CPU the window's body runs eagerly;
tests/test_torch_cuda.py holds the captured CUDA graph to it. Float32
throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu.runtime import batching as jbatching
from defer_tpu.runtime.decode_server import serve_greedy as jax_serve_greedy
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.runtime import batching
from defer_tpu_torch.runtime.decode_server import DecodeServer, serve_greedy

CPU = torch.device("cpu")
JAX = {"gpt": jax_tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}
PROMPTS = [([3, 9, 27], 7), ([5], 4), ([11, 2, 8, 1, 6], 9), ([4, 4], 2),
           ([1, 7, 7, 2], 1)]


def _make(family, seq_len=64):
    jdec = JAX[family](seq_len)
    jparams = jdec.init(jax.random.key(0))
    return (PORT[family](seq_len, device=CPU), params_from_jax(jparams, CPU),
            jdec, jparams)


@pytest.fixture(scope="module")
def gpt():
    return _make("gpt")


@pytest.fixture(scope="module")
def llama():
    return _make("llama")


def _requests(vocab):
    return [(torch.tensor([p]) % vocab, s) for p, s in PROMPTS]


def _jax_requests(reqs):
    return [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in reqs]


def _same(outs, want):
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("family,K", [("gpt", 2), ("gpt", 4), ("llama", 4)])
def test_greedy_window_matches_jax_and_k1(family, K, gpt, llama):
    dec, params, jdec, jparams = {"gpt": gpt, "llama": llama}[family]
    reqs = _requests(dec.cfg.vocab_size)
    outs, stats = serve_greedy(dec, params, reqs, max_batch=2,
                               decode_window=K)
    k1, stats1 = serve_greedy(dec, params, reqs, max_batch=2)
    jouts, jstats = jax_serve_greedy(jdec, jparams, _jax_requests(reqs),
                                     max_batch=2, decode_window=K)
    _same(outs, k1)
    _same(outs, jouts)
    assert stats["host_dispatches"] == jstats["host_dispatches"]
    assert stats["host_dispatches"] < stats1["host_dispatches"]
    assert stats["tokens_per_dispatch"] == pytest.approx(
        jstats["tokens_per_dispatch"])
    assert stats["decode_window"] == K
    assert stats["graph_replays"] == 0  # the CPU runs the body eagerly


SAMPLINGS = [
    SamplingParams(temperature=0.8, top_k=20, seed=7),
    None,
    SamplingParams(temperature=1.3, top_p=0.9, min_p=0.05, seed=42),
    SamplingParams(temperature=0.6, seed=3),
    SamplingParams(temperature=1.0, seed=0),
]


@pytest.mark.parametrize("samplings", [SAMPLINGS, [
    SamplingParams(temperature=0.9, seed=11), None,
    SamplingParams(temperature=1.2, min_p=0.1, seed=4), None, None]],
    ids=["sort", "nosort"])
def test_sampled_window_matches_k1_per_seed(gpt, samplings):
    """Each sampled slot's K=4 stream equals its K=1 stream: the
    window draws each slot's uniforms from its own generator in tick
    order, in both the sorting and the sort-free modes."""
    dec, params, _, _ = gpt
    reqs = _requests(dec.cfg.vocab_size)
    k1, _ = serve_greedy(dec, params, reqs, max_batch=2, sampling=samplings)
    k4, _ = serve_greedy(dec, params, reqs, max_batch=2,
                         sampling=samplings, decode_window=4)
    _same(k4, k1)


def test_eos_and_budget_freeze_rows_mid_window(gpt):
    """A row that emits eos mid-window stops there (its output ends with
    the eos, the tail of the window dropped), and a row whose budget
    runs out mid-window stops at its budget: both as K=1 and as the
    JAX package's window."""
    dec, params, jdec, jparams = gpt
    reqs = _requests(dec.cfg.vocab_size)
    free, _ = serve_greedy(dec, params, reqs, max_batch=2)
    # Request 2's seventh generated token: the second sub-step of its
    # second window (its first token comes from admission).
    eos = int(free[2][0, 5 + 6])
    k1, _ = serve_greedy(dec, params, reqs, max_batch=2, eos_id=eos)
    srv = DecodeServer(dec, params, max_batch=2, eos_id=eos, decode_window=4)
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    k4 = [done[r] for r in rids]
    jouts, _ = jax_serve_greedy(jdec, jparams, _jax_requests(reqs),
                                max_batch=2, eos_id=eos, decode_window=4)
    _same(k4, k1)
    _same(k4, jouts)
    assert k4[2].shape[1] == 5 + 7 < 5 + reqs[2][1]
    assert int(k4[2][0, -1]) == eos
    assert srv.obs.window_truncated.value > 0
    # Budgets of 7, 4, 9, 2, 1: all but 4 end inside a window.
    assert [o.shape[1] - p.shape[1] for o, (p, _) in zip(k4, reqs)][3:] \
        == [2, 1]


def test_dispatches_count_windows(gpt):
    dec, params, _, _ = gpt
    reqs = [(torch.tensor([[3, 1]]), 13), (torch.tensor([[9, 5]]), 13)]
    srv = DecodeServer(dec, params, max_batch=2, decode_window=4)
    for p, s in reqs:
        srv.submit(p, s)
    srv.run()
    # Admission emits token 1; the other 12 take three windows of 4.
    assert srv.dispatches == srv.ticks == 3
    assert srv.window_tokens == 24
    srv1 = DecodeServer(dec, params, max_batch=2)
    for p, s in reqs:
        srv1.submit(p, s)
    srv1.run()
    assert srv1.dispatches == srv1.ticks == 12


def test_window_streams_and_stops_in_k1_order(gpt):
    """Streaming callbacks fire in the K=1 interleaving, and a stop
    sequence cuts a request mid-window exactly where K=1 cuts it."""
    dec, params, _, _ = gpt
    reqs = _requests(dec.cfg.vocab_size)[:4]
    full = dec.generate(params, reqs[2][0], reqs[2][1])[0, 5:]
    stop = [int(full[3]), int(full[4])]

    def serve(K):
        events = []
        srv = DecodeServer(dec, params, max_batch=2, decode_window=K,
                           on_token=lambda r, t, d: events.append((r, t, d)))
        rids = [srv.submit(p, s, stop=[stop] if i == 2 else None)
                for i, (p, s) in enumerate(reqs)]
        done = srv.run()
        return events, [done[r] for r in rids]

    ev1, out1 = serve(1)
    ev4, out4 = serve(4)
    _same(out4, out1)
    assert out4[2][0, -2:].tolist() == stop
    # Per request the stream is the same; finals mark the last token.
    for r in range(len(reqs)):
        assert [e for e in ev4 if e[0] == r] == [e for e in ev1 if e[0] == r]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batching_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, size=5).tolist()
    assert list(batching.window_drain_order(lens, 6)) == list(
        jbatching.window_drain_order(lens, 6))
    props = rng.integers(0, 4, size=(6, 5))
    preds = np.where(rng.random((6, 5)) < 0.7, props,
                     rng.integers(0, 4, size=(6, 5)))
    np.testing.assert_array_equal(batching.accept_lengths(props, preds),
                                  jbatching.accept_lengths(props, preds))
    with pytest.raises(ValueError, match="matching"):
        batching.accept_lengths(props, preds[:, :3])
