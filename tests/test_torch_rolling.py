"""The port's rolling KV cache (GptDecoder(rolling_cache=True)) against
the JAX package's.

The cache holds cfg.window slots and position p lands in slot
p % window; a rolling step attends through the einsum path, never
flash_decode. The same weights (the JAX package's init, carried over
with `params_from_jax`) and the same ids go through both packages:
logits past the window within atol 1e-4 (f32), greedy tokens identical,
the per-slot rolling server equal to the JAX package's, and the
refusals the JAX package makes. Float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models import gpt as jgpt
from defer_tpu.models.llama import mistral_config as jax_mistral_config
from defer_tpu.runtime.decode_server import serve_greedy as jax_serve_greedy
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models import speculative
from defer_tpu_torch.models.gpt import GptDecoder, tiny_gpt
from defer_tpu_torch.models.llama import mistral_config
from defer_tpu_torch.ops import flash_decode as fd
from defer_tpu_torch.runtime.decode_server import (
    DecodeServer,
    DraftLanes,
    serve_greedy,
)

CPU = torch.device("cpu")
W = 6
SHAPE = dict(num_layers=2, dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
             vocab_size=96, max_len=32, window=W)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_mistral_config(**SHAPE)
    jroll = jgpt.GptDecoder(jcfg, compute_dtype=jnp.float32,
                            rolling_cache=True)
    jparams = jroll.init(jax.random.key(0))
    roll = GptDecoder(mistral_config(**SHAPE), compute_dtype=torch.float32,
                      rolling_cache=True, device=CPU)
    flat = GptDecoder(mistral_config(**SHAPE), compute_dtype=torch.float32,
                      device=CPU)
    return roll, flat, params_from_jax(jparams, CPU), jroll, jparams


def _ids(shape, seed=1, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def test_cache_holds_window_slots(model):
    roll, flat, *_ = model
    cache = roll.init_cache(2)
    assert cache["k"].shape == (2, 2, 2, W, 16)
    assert flat.init_cache(2)["k"].shape[3] == SHAPE["max_len"]


def test_rolling_logits_match_jax_past_the_window(model):
    """Teacher-forced logits of 3 windows' worth of tokens: a 4-token
    prefill, then T=1 steps that wrap the cache twice."""
    roll, _, params, jroll, jparams = model
    ids = _ids((2, 3 * W))
    step = roll.make_step(donate=False)
    jstep = jroll.make_step(donate=False)
    c, jc = roll.init_cache(2), jroll.init_cache(2)
    outs, jouts = [], []
    for a, b in [(0, 4)] + [(t, t + 1) for t in range(4, 3 * W)]:
        lg, c = step(params, c, torch.from_numpy(ids[:, a:b]))
        jlg, jc = jstep(jparams, jc, jnp.asarray(ids[:, a:b]))
        outs.append(lg)
        jouts.append(np.asarray(jlg))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               np.concatenate(jouts, 1), rtol=0, atol=1e-4)


@pytest.mark.parametrize("t", [5, 2 * W + 3])
def test_rolling_reference_logits_match_jax_and_flat(model, t):
    """reference_logits streams sequences longer than the window in
    window-sized steps (multi-token rolling steps over [cache, new
    rows]); it equals JAX's and the flat windowed decoder's."""
    roll, flat, params, jroll, jparams = model
    ids = _ids((2, t), seed=t)
    got = roll.reference_logits(params, torch.from_numpy(ids)).numpy()
    want = np.asarray(jroll.reference_logits(jparams, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got, flat.reference_logits(params, torch.from_numpy(ids)).numpy(),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("t0,steps", [(3, 20), (2 * W + 1, 9)])
def test_rolling_generate_matches_jax(model, t0, steps):
    """Greedy tokens identical, past max_len when the steps ask for it;
    a prompt longer than the window streams in window-sized chunks."""
    roll, _, params, jroll, jparams = model
    ids = _ids((1, t0), seed=7)
    got = roll.generate(params, torch.from_numpy(ids), steps)
    want = jroll.generate(jparams, jnp.asarray(ids, jnp.int32), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_generates_past_max_len(model):
    roll, flat, params, _, _ = model
    prompt = torch.zeros((1, 3), dtype=torch.long)
    out = roll.generate(params, prompt, 40)  # 43 > max_len 32
    assert out.shape == (1, 43)
    torch.testing.assert_close(out[:, :23], flat.generate(params, prompt, 20),
                               rtol=0, atol=0)


def test_rolling_steps_skip_flash_decode(model):
    roll, _, params, _, _ = model
    fd.flash_decode.launches = 0
    calls = []
    orig = fd.flash_decode_plain
    fd.flash_decode_plain = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        roll.generate(params, torch.tensor([[1, 2, 3]]), 10)
    finally:
        fd.flash_decode_plain = orig
    assert not calls


def test_rolling_server_matches_jax_server(model):
    """Per-slot rolling caches behind DecodeServer: each slot writes its
    own pos % window; prompts shorter and longer than the window, and
    generation that crosses it, equal the JAX package's server."""
    roll, _, params, jroll, jparams = model
    reqs = [([3, 9, 27], 12), ([5], 4), (_ids(13, seed=2).tolist(), 6),
            ([4, 4], 9)]
    treqs = [(torch.tensor([p]), s) for p, s in reqs]
    outs, _ = serve_greedy(roll, params, treqs, max_batch=2)
    jouts, _ = jax_serve_greedy(
        jroll, jparams, [(jnp.asarray([p], jnp.int32), s) for p, s in reqs],
        max_batch=2)
    for (p, s), got, want in zip(treqs, outs, jouts):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        torch.testing.assert_close(got, roll.generate(params, p, s),
                                   rtol=0, atol=0)
    wouts, _ = serve_greedy(roll, params, treqs, max_batch=2,
                            decode_window=4)
    for got, want in zip(wouts, outs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rolling_refusals(model):
    """What the JAX package refuses: no window, learned positions, a
    prefix cache over a rolling decoder, a rolling draft, speculation
    over a rolling cache, and a step longer than the window."""
    roll, _, params, _, _ = model
    with pytest.raises(ValueError, match="rolling_cache"):
        GptDecoder(tiny_gpt(device=CPU).cfg, rolling_cache=True, device=CPU)
    with pytest.raises(ValueError, match="rolling_cache"):
        GptDecoder(mistral_config(**{**SHAPE, "window": None}),
                   rolling_cache=True, device=CPU)
    with pytest.raises(ValueError, match="prefix"):
        DecodeServer(roll, params, prefix_ids=torch.tensor([[1, 2]]))
    with pytest.raises(ValueError, match="rolling"):
        DraftLanes(roll, params, 2)
    with pytest.raises(ValueError, match="rolling cache"):
        speculative.speculative_generate(
            roll, params, roll, params, torch.zeros((1, 3), dtype=torch.long),
            4)
    with pytest.raises(ValueError, match="window"):
        roll.make_step(donate=False)(params, roll.init_cache(1),
                                     torch.zeros((1, W + 1),
                                                 dtype=torch.long))
