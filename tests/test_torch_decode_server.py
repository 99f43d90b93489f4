"""The port's continuous-batching DecodeServer.

Mirrors tests/test_decode_server.py: every request's output must equal
the port's own solo `generate` of it (greedy token for token; a sampled
slot seeded `s` against a solo generate with a generator seeded `s`)
while decode ticks are shared. Greedy server outputs must also equal
`defer_tpu`'s DecodeServer on the same weights (carried over with
`params_from_jax`). Sampled streams are not compared with JAX's: torch
and JAX generators differ (tests/test_torch_gpt.py holds the
distribution). Decode windows, constraints and adapter banks have their
own files (test_torch_window.py, test_torch_constrain.py,
test_torch_lora.py). Everything runs in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu.runtime.decode_server import serve_greedy as jax_serve_greedy
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.models.quant import quantize_decoder_params
from defer_tpu_torch.runtime.decode_server import DecodeServer, serve_greedy

CPU = torch.device("cpu")
JAX = {"gpt": jax_tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}


def _make(family, seq_len=64):
    """The port's decoder with the JAX package's weights for `family`."""
    jparams = JAX[family](seq_len).init(jax.random.key(0))
    return PORT[family](seq_len, device=CPU), params_from_jax(jparams, CPU)


@pytest.fixture(scope="module")
def gpt64():
    return _make("gpt")


PROMPTS = [([3, 9, 27], 7), ([5], 4), ([11, 2, 8, 1, 6], 9), ([4, 4], 2),
           ([1, 7, 7, 2], 1)]


def _requests(vocab):
    return [(torch.tensor([p]) % vocab, s) for p, s in PROMPTS]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_server_matches_solo_generate_and_jax(family):
    """Five requests of different prompt lengths and step counts through
    2 slots: each output equals its solo generate (per-slot positions,
    admission mid-flight, stale-row masking), and equals defer_tpu's
    DecodeServer on the same weights."""
    dec, params = _make(family)
    reqs = _requests(dec.cfg.vocab_size)
    outs, stats = serve_greedy(dec, params, reqs, max_batch=2)
    jdec = JAX[family](64)
    jouts, jstats = jax_serve_greedy(
        jdec, jdec.init(jax.random.key(0)),
        [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in reqs],
        max_batch=2,
    )
    for (prompt, steps), got, jgot in zip(reqs, outs, jouts):
        want = dec.generate(params, prompt, steps)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert stats["ticks"] == jstats["ticks"] > 0


def test_batched_ticks_are_shared(gpt64):
    dec, params = gpt64
    reqs = [(torch.tensor([[3, 1]]), 12), (torch.tensor([[9, 5]]), 12)]
    _, stats = serve_greedy(dec, params, reqs, max_batch=2)
    assert stats["solo_steps"] == 24
    assert stats["ticks"] <= 12  # admission yields token 1 per request
    assert stats.metrics["counters"]


def test_submit_validation():
    dec, params = _make("gpt", 32)
    srv = DecodeServer(dec, params, max_batch=2)
    with pytest.raises(ValueError, match="one request"):
        srv.submit(torch.zeros((2, 3), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="at least one token"):
        srv.submit(torch.zeros((1, 0), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(torch.zeros((1, 3), dtype=torch.long), 64)
    with pytest.raises(ValueError, match="num_steps"):
        srv.submit(torch.zeros((1, 3), dtype=torch.long), 0)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_prefix_cached_serving_matches_solo(family):
    """With a shared system prefix, every served suffix+generation equals
    solo decoding of the concatenated prompt, and the prefix lane is
    never written by an admission."""
    dec, params = _make(family)
    prefix = torch.tensor([[7, 3, 1, 12, 9, 2]])
    reqs = _requests(dec.cfg.vocab_size)
    srv = DecodeServer(dec, params, max_batch=2, prefix_ids=prefix)
    lane = srv._prefix_cache["k"].clone()
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    torch.testing.assert_close(srv._prefix_cache["k"], lane, rtol=0, atol=0)
    P = prefix.shape[1]
    for (suffix, steps), rid in zip(reqs, rids):
        full = torch.cat([prefix, suffix], dim=1)
        want = dec.generate(params, full, steps)[:, P:]
        torch.testing.assert_close(done[rid], want, rtol=0, atol=0)
    _, stats = serve_greedy(dec, params, reqs, max_batch=2,
                            prefix_ids=prefix)
    assert stats["saved_prefill_tokens"] == P * len(reqs)


def test_eos_frees_slots_early(gpt64):
    dec, params = gpt64
    reqs = _requests(dec.cfg.vocab_size)[:4]
    free = dec.generate(params, reqs[0][0], reqs[0][1])
    eos = int(free[0, reqs[0][0].shape[1] + 1])
    _, stats_free = serve_greedy(dec, params, reqs, max_batch=2)
    outs, stats = serve_greedy(dec, params, reqs, max_batch=2, eos_id=eos)
    assert stats["ticks"] < stats_free["ticks"]
    stopped_early = False
    for (p, s), got in zip(reqs, outs):
        want = dec.generate(params, p, s, eos_id=eos)
        assert got.shape[1] <= want.shape[1]
        torch.testing.assert_close(got[0], want[0, : got.shape[1]],
                                   rtol=0, atol=0)
        if got.shape[1] < want.shape[1]:
            assert got[0, -1] == eos
            stopped_early = True
    assert stopped_early


def test_streaming_callback_matches_outputs(gpt64):
    dec, params = gpt64
    reqs = _requests(dec.cfg.vocab_size)[:4]
    streamed: dict[int, list[int]] = {}
    finals: list[int] = []

    def on_token(rid, tok, done):
        streamed.setdefault(rid, []).append(tok)
        if done:
            finals.append(rid)

    srv = DecodeServer(dec, params, max_batch=2, on_token=on_token)
    rids = [srv.submit(p, s) for p, s in reqs]
    done = srv.run()
    assert sorted(finals) == sorted(rids) and len(finals) == len(set(finals))
    for (p, s), rid in zip(reqs, rids):
        assert streamed[rid] == done[rid][0, p.shape[1]:].tolist()
        assert len(streamed[rid]) == s


def test_prefix_validation():
    dec, params = _make("gpt", 32)
    with pytest.raises(ValueError, match=r"\[1, P\]"):
        DecodeServer(dec, params, prefix_ids=torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="no room"):
        DecodeServer(dec, params,
                     prefix_ids=torch.zeros((1, 32), dtype=torch.long))
    srv = DecodeServer(dec, params, max_batch=2,
                       prefix_ids=torch.zeros((1, 10), dtype=torch.long))
    with pytest.raises(ValueError, match="prefix 10"):
        srv.submit(torch.zeros((1, 4), dtype=torch.long), 19)


def test_server_serves_int8_params():
    dec, params = _make("llama")
    qparams = quantize_decoder_params(params)
    reqs = _requests(dec.cfg.vocab_size)[:3]
    outs, _ = serve_greedy(dec, qparams, reqs, max_batch=2)
    for (prompt, steps), got in zip(reqs, outs):
        want = dec.generate(qparams, prompt, steps)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


SAMPLINGS = [
    SamplingParams(temperature=0.8, top_k=20, seed=7),
    None,  # greedy slot sharing ticks with sampled neighbours
    SamplingParams(temperature=1.3, top_p=0.9, min_p=0.05, seed=42),
    SamplingParams(temperature=0.6, top_k=8, top_p=0.95, seed=3),
    SamplingParams(temperature=1.0, seed=0),
]


def _solo(dec, params, prompt, steps, sp):
    if sp is None:
        return dec.generate(params, prompt, steps)
    return dec.generate(
        params, prompt, steps, temperature=sp.temperature, top_k=sp.top_k,
        top_p=sp.top_p, min_p=sp.min_p,
        generator=torch.Generator().manual_seed(sp.seed),
    )


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_per_request_sampling_matches_solo(family):
    dec, params = _make(family)
    reqs = _requests(dec.cfg.vocab_size)
    outs, _ = serve_greedy(dec, params, reqs, max_batch=2,
                           sampling=SAMPLINGS)
    for (prompt, steps), sp, got in zip(reqs, SAMPLINGS, outs):
        torch.testing.assert_close(got, _solo(dec, params, prompt, steps, sp),
                                   rtol=0, atol=0, msg=f"sampling={sp}")


def test_sampling_slot_reuse_resets_policy(gpt64):
    dec, params = gpt64
    reqs = _requests(dec.cfg.vocab_size)[:2]
    sp = SamplingParams(temperature=1.5, seed=1)
    srv = DecodeServer(dec, params, max_batch=1)
    r1 = srv.submit(reqs[0][0], reqs[0][1], sampling=sp)
    r2 = srv.submit(reqs[1][0], reqs[1][1])  # greedy, same slot later
    done = srv.run()
    torch.testing.assert_close(done[r2], _solo(dec, params, *reqs[1], None),
                               rtol=0, atol=0)
    torch.testing.assert_close(done[r1], _solo(dec, params, *reqs[0], sp),
                               rtol=0, atol=0)
    assert srv._sampler.generators == [None]
    assert srv._sampler.row_temp == [0.0]


def test_sampling_validation(gpt64):
    dec, params = gpt64
    srv = DecodeServer(dec, params, max_batch=1)
    prompt = torch.tensor([[1, 2]])
    with pytest.raises(ValueError, match="temperature"):
        srv.submit(prompt, 2, sampling=SamplingParams(temperature=-1.0))
    with pytest.raises(ValueError, match="top_p"):
        srv.submit(prompt, 2,
                   sampling=SamplingParams(temperature=1.0, top_p=0.0))


def test_stop_sequence_finishes_request_mid_budget(gpt64):
    dec, params = gpt64
    prompt = torch.tensor([[3, 9, 27]])
    full = dec.generate(params, prompt, 12)[0]
    gen = full[3:]
    stop = [int(gen[5]), int(gen[6])]
    srv = DecodeServer(dec, params, max_batch=2)
    r_stop = srv.submit(prompt, 12, stop=[stop])
    r_free = srv.submit(prompt, 12)
    done = srv.run()
    got = done[r_stop][0]
    # Mid-budget, at the stop pair's first occurrence.
    first_end = next(j for j in range(1, len(gen))
                     if gen[j - 1:j + 1].tolist() == stop)
    assert len(got) == 3 + first_end + 1 < 3 + 12
    assert got[-2:].tolist() == stop
    torch.testing.assert_close(got, full[: len(got)], rtol=0, atol=0)
    torch.testing.assert_close(done[r_free][0], full, rtol=0, atol=0)


def test_stop_sequence_composes_with_sampling(gpt64):
    dec, params = gpt64
    prompt = torch.tensor([[11, 2, 8]])
    sp = SamplingParams(temperature=1.1, top_k=30, seed=9)
    base = _solo(dec, params, prompt, 12, sp)[0]
    gen = base[3:]
    stop = [int(gen[4]), int(gen[5])]
    first_end = next(j for j in range(1, len(gen))
                     if gen[j - 1:j + 1].tolist() == stop)
    srv = DecodeServer(dec, params, max_batch=2)
    r = srv.submit(prompt, 12, sampling=sp, stop=[stop])
    got = srv.run()[r][0]
    assert len(got) == 3 + first_end + 1
    torch.testing.assert_close(got, base[: len(got)], rtol=0, atol=0)


def test_nosort_dispatch_preserves_solo_parity(gpt64):
    """Slots that sample without top-k/top-p take the sort-free draw
    every tick (row_sort stays all-False) and still equal their solo
    runs; a top-k admission flips its slot's row_sort while it lives."""
    dec, params = gpt64
    reqs = _requests(dec.cfg.vocab_size)[:3]
    samps = [SamplingParams(temperature=0.9, seed=11), None,
             SamplingParams(temperature=1.2, min_p=0.1, seed=4)]
    srv = DecodeServer(dec, params, max_batch=2)
    rids = [srv.submit(p, s, sampling=sp) for (p, s), sp in zip(reqs, samps)]
    done = srv.run()
    assert not any(srv._sampler.row_sort)
    for (p, s), sp, r in zip(reqs, samps, rids):
        torch.testing.assert_close(done[r], _solo(dec, params, p, s, sp),
                                   rtol=0, atol=0)

    sp = SamplingParams(temperature=1.0, top_k=5, seed=1)
    srv2 = DecodeServer(dec, params, max_batch=2)
    r_sorted = srv2.submit(reqs[0][0], 3, sampling=sp)
    sorted_at_release = []
    orig_release = srv2._sampler.release

    def spy(i):
        sorted_at_release.append(srv2._sampler.row_sort[i])
        orig_release(i)

    srv2._sampler.release = spy
    done2 = srv2.run()
    assert any(sorted_at_release)
    assert not any(srv2._sampler.row_sort)
    torch.testing.assert_close(done2[r_sorted],
                               _solo(dec, params, reqs[0][0], 3, sp),
                               rtol=0, atol=0)


def test_knobs_not_ported_raise(gpt64):
    """Every knob of the flat server is ported now: the ones this file's
    first slice left raising validate their inputs as the JAX package
    does (windows, constraints, adapter banks)."""
    dec, params = gpt64
    DecodeServer(dec, params, decode_window=2)
    with pytest.raises(ValueError, match="decode_window"):
        DecodeServer(dec, params, decode_window=0)
    with pytest.raises(ValueError, match="empty"):
        DecodeServer(dec, params, eos_id=0, constraints={})
    with pytest.raises(ValueError, match="eos_id"):
        DecodeServer(dec, params, constraints={})
    unmerged = {**params, "stack": {**params["stack"],
                                    "wq:a": torch.zeros(4, 64, 2)}}
    with pytest.raises(ValueError, match="LoRA"):
        DecodeServer(dec, unmerged)
    srv = DecodeServer(dec, params, max_batch=1)
    with pytest.raises(ValueError, match="constraint"):
        srv.submit(torch.tensor([[1]]), 2,
                   sampling=SamplingParams(constraint="json"))
    with pytest.raises(ValueError, match="adapter"):
        srv.submit(torch.tensor([[1]]), 2, adapter_id=1)
