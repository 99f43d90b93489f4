"""GptDecoder, its sampling policies, the stack helpers and int8 weights,
through both packages.

Weights are `defer_tpu`'s random init (tiny_llama(64): RMSNorm, rotary,
GQA, SwiGLU; tiny_gpt(32)/(64): layer norm, learned positions, biases,
gelu), carried over with `params_from_jax`; token ids are numpy draws
from fixed seeds. Everything runs in float32 on the CPU. Tolerances:
logits within atol 1e-4 (a few float32 blocks summed in other orders);
greedy tokens identical; `truncate_logits(_batched)` exactly equal on
the same logits; int8 decoding within the bound tests/test_quant.py
holds JAX to (cosine > 0.99 against full precision).

Sampling: torch and JAX generators give different streams from the same
seed, so sampled tokens are not compared with JAX's. What is compared:
the filters (exactly), the categorical's distribution (frequencies
against the softmax), and the port's reproducibility from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models import gpt as jgpt
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu.models.quant import quantize_decoder_params as jax_quantize
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models import gpt
from defer_tpu_torch.models.gpt import GptDecoder, tiny_gpt
from defer_tpu_torch.models.llama import mistral_config, tiny_llama
from defer_tpu_torch.models.quant import (
    dequantize_leaf,
    quantization_error,
    quantize_decoder_params,
    quantize_leaf,
)
from defer_tpu_torch.parallel import transformer_stack as ts

CPU = torch.device("cpu")
ATOL = 1e-4
FAMILIES = {
    "llama": (jax_tiny_llama, tiny_llama),
    "gpt": (jgpt.tiny_gpt, tiny_gpt),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, jax decoder, jax params, port decoder, port params)."""
    jmake, make = FAMILIES[request.param]
    jdec = jmake(64)
    jparams = jdec.init(jax.random.key(0))
    return (request.param, jdec, jparams, make(64, device=CPU),
            params_from_jax(jparams))


def _ids(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _both(ids):
    return jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)


def test_reference_logits_match(family):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 11)))
    want = np.asarray(jdec.reference_logits(jparams, jids))
    got = dec.reference_logits(params, ids)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_prefill_and_decode_steps_match(family):
    """Logits of a prefill step and of each T=1 step after it, with the
    caches carried on both sides (the port's written in place)."""
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 6)))
    jstep, step = jdec.make_step(donate=False), dec.make_step()
    jcache, cache = jdec.init_cache(2), dec.init_cache(2)
    jl, jcache = jstep(jparams, jcache, jids)
    l, cache = step(params, cache, ids)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=ATOL)
    for t in range(5):
        tok = _ids(dec.cfg.vocab_size, (2, 1), seed=10 + t)
        jtok, ttok = _both(tok)
        jl, jcache = jstep(jparams, jcache, jtok)
        l, cache = step(params, cache, ttok)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == 11
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=ATOL)


def test_greedy_generate_matches_jax(family):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 5)))
    want = np.asarray(jdec.generate(jparams, jids, 12))
    got = dec.generate(params, ids, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_matches_jax_through_its_kernel(family, monkeypatch):
    """Under DEFER_TPU_PALLAS_INTERPRET=1 the JAX decoder's T=1 step runs
    its flash_decode kernel (f32 probabilities, as the port's plain
    version): a fresh JAX decoder, since compiled steps are memoised."""
    name, _, jparams, dec, params = family
    monkeypatch.setenv("DEFER_TPU_PALLAS_INTERPRET", "1")
    jdec = FAMILIES[name][0](64)
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 5), seed=3))
    want = np.asarray(jdec.generate(jparams, jids, 8))
    np.testing.assert_array_equal(dec.generate(params, ids, 8).numpy(),
                                  want)


@pytest.mark.parametrize("chunk", [3, 4, 16])
def test_chunked_prefill_matches_jax(family, chunk):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (1, 13), seed=4))
    jlast, jcache = jdec.prefill(jparams, jdec.init_cache(1), jids,
                                 chunk=chunk)
    last, cache = dec.prefill(params, dec.init_cache(1), ids, chunk=chunk)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == 13
    want = np.asarray(jdec.generate(jparams, jids, 6, prefill_chunk=chunk))
    got = dec.generate(params, ids, 6, prefill_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_prefill_at_the_cache_end():
    """The tail piece is not padded when the padded write would leave
    the cache (dynamic_update_slice would clamp it over earlier rows)."""
    jdec = jgpt.tiny_gpt(16)
    jparams = jdec.init(jax.random.key(0))
    dec, params = tiny_gpt(16, device=CPU), params_from_jax(jparams)
    jids, ids = _both(_ids(128, (1, 14), seed=5))
    jlast, _ = jdec.prefill(jparams, jdec.init_cache(1), jids, chunk=4)
    last, cache = dec.prefill(params, dec.init_cache(1), ids, chunk=4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    assert int(cache["pos"]) == 14
    with pytest.raises(ValueError, match="max_len"):
        dec.prefill(params, cache, ids[:, :3])


def test_eos_pins_finished_rows(family):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (3, 4), seed=6))
    free = dec.generate(params, ids, 12).numpy()
    eos = int(free[0, 4 + 2])  # a token row 0 emits at its third step
    want = np.asarray(jdec.generate(jparams, jids, 12, eos_id=eos))
    got = dec.generate(params, ids, 12, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 6:] == eos).all()


def test_stop_sequences_match_jax(family):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 3), seed=7))
    free = dec.generate(params, ids, 12).numpy()
    stop = [[int(free[0, 7]), int(free[0, 8])]]
    want = np.asarray(jdec.generate(jparams, jids, 12, stop_sequences=stop,
                                    pad_id=0))
    got = dec.generate(params, ids, 12, stop_sequences=stop, pad_id=0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repetition_penalty_matches_jax(family):
    _, jdec, jparams, dec, params = family
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 4), seed=8))
    want = np.asarray(jdec.generate(jparams, jids, 10, rep_penalty=1.3))
    got = dec.generate(params, ids, 10, rep_penalty=1.3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_params_match_jax_and_stay_close():
    """Quantized decoding: the port's int8 tree equals JAX's, carried
    over (int8 stays int8, f32 scales stay f32), and decodes to JAX's
    logits; against full precision it stays within test_quant.py's
    bound (cosine > 0.99)."""
    jdec = jax_tiny_llama()
    jparams = jdec.init(jax.random.key(0))
    jq = jax_quantize(jparams)
    dec = tiny_llama(device=CPU)
    full = params_from_jax(jparams)
    carried = params_from_jax(jq)
    mine = quantize_decoder_params(full)
    assert carried["stack"]["wq"]["q"].dtype == torch.int8
    assert carried["stack"]["wq"]["s"].dtype == torch.float32
    for key in ("wq", "w2"):
        np.testing.assert_array_equal(mine["stack"][key]["q"].numpy(),
                                      carried["stack"][key]["q"].numpy())
        np.testing.assert_allclose(mine["stack"][key]["s"].numpy(),
                                   carried["stack"][key]["s"].numpy(),
                                   rtol=1e-6)
    jids, ids = _both(_ids(dec.cfg.vocab_size, (2, 8), seed=9))
    want = np.asarray(jdec.reference_logits(jq, jids))
    quant = dec.reference_logits(mine, ids).numpy()
    np.testing.assert_allclose(quant, want, atol=ATOL)
    ref = dec.reference_logits(full, ids).numpy().reshape(-1)
    q = quant.reshape(-1)
    cos = float(np.dot(ref, q) / (np.linalg.norm(ref) * np.linalg.norm(q)))
    assert cos > 0.99, cos
    np.testing.assert_array_equal(
        dec.generate(mine, ids[:1, :3], 4).numpy(),
        np.asarray(jdec.generate(jq, jids[:1, :3], 4)),
    )


def test_quantize_leaf_bounds():
    w = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 128), np.float32)
    )
    leaf = quantize_leaf(w)
    assert leaf["q"].dtype == torch.int8 and leaf["s"].shape == (1, 128)
    back = dequantize_leaf(leaf, torch.float32)
    assert ((back - w).abs() <= leaf["s"] * 0.5 + 1e-7).all()
    assert quantization_error(w) < 1 / 127
    stacked = quantize_leaf(torch.randn(3, 16, 32))
    assert stacked["s"].shape == (3, 1, 32)
    zero = quantize_leaf(torch.zeros(4, 8))
    assert (zero["q"] == 0).all() and (zero["s"] == 1.0).all()


TRUNCATE_CASES = [
    (0, 1.0, 0.0),
    (5, 1.0, 0.0),
    (0, 0.7, 0.0),
    (0, 1.0, 0.2),
    (12, 0.85, 0.05),
    (1, 0.5, 0.5),
]


def test_truncate_logits_equal_jax():
    logits = np.random.default_rng(11).standard_normal(
        (len(TRUNCATE_CASES), 33)
    ).astype(np.float32) * 3.0
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    got_b = gpt.truncate_logits_batched(
        tl,
        torch.tensor([c[0] for c in TRUNCATE_CASES], dtype=torch.int32),
        torch.tensor([c[1] for c in TRUNCATE_CASES]),
        torch.tensor([c[2] for c in TRUNCATE_CASES]),
    ).numpy()
    want_b = np.asarray(jgpt.truncate_logits_batched(
        jl,
        jnp.asarray([c[0] for c in TRUNCATE_CASES], jnp.int32),
        jnp.asarray([c[1] for c in TRUNCATE_CASES], jnp.float32),
        jnp.asarray([c[2] for c in TRUNCATE_CASES], jnp.float32),
    ))
    np.testing.assert_array_equal(got_b, want_b)
    for r, (k, p, mp) in enumerate(TRUNCATE_CASES):
        want = np.asarray(jgpt.truncate_logits(jl[r:r + 1], top_k=k,
                                               top_p=p, min_p=mp))
        got = gpt.truncate_logits(tl[r:r + 1], top_k=k, top_p=p, min_p=mp)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_b[r], got.numpy()[0])


def test_nosort_sampler_equals_the_sorting_one():
    b, v = 5, 97
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((b, v), np.float32) * 4.0
    )
    temp = torch.tensor([0.0, 0.7, 1.3, 1.0, 0.0])
    minp = torch.tensor([0.0, 0.05, 0.0, 0.2, 0.1])

    def gens():
        return [None if t == 0 else torch.Generator().manual_seed(i)
                for i, t in enumerate(temp.tolist())]

    want = gpt.sample_token_batched(
        logits, gens(), temp, torch.zeros(b, dtype=torch.int32),
        torch.ones(b), minp,
    )
    got = gpt.sample_token_batched_nosort(logits, gens(), temp, minp)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got[0] == logits[0].argmax() and got[4] == logits[4].argmax()


def test_categorical_has_the_softmax_distribution():
    """The stream differs from JAX's; the distribution does not: the
    frequencies of 40000 draws from one row of logits (at temperature
    0.8, top_k 6) match softmax of the filtered logits, and JAX's
    categorical, within 0.01."""
    row = np.array([1.0, 0.5, 0.0, -0.5, 2.0, 0.2, -1.0, 0.8], np.float32)
    n = 40000
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    toks = gpt.sample_token(logits, torch.Generator().manual_seed(0), 0.8,
                            top_k=6)
    freq = np.bincount(toks.numpy(), minlength=8) / n
    filt = gpt.truncate_logits(torch.from_numpy(row[None]) / 0.8, top_k=6)
    want = torch.softmax(filt, -1).numpy()[0]
    np.testing.assert_allclose(freq, want, atol=0.01)
    jtok = jax.random.categorical(
        jax.random.key(0), jnp.asarray(filt.numpy()), shape=(n,)
    )
    jfreq = np.bincount(np.asarray(jtok), minlength=8) / n
    np.testing.assert_allclose(freq, jfreq, atol=0.01)


def test_sampled_generate_is_reproducible(family):
    _, _, _, dec, params = family
    ids = torch.from_numpy(_ids(dec.cfg.vocab_size, (2, 4), seed=12))

    def run(seed):
        return dec.generate(params, ids, 10, temperature=1.1, top_k=20,
                            top_p=0.9,
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert (a >= 0).all() and (a < dec.cfg.vocab_size).all()


def test_donate_flag_decides_whether_the_cache_is_written(family):
    _, _, _, dec, params = family
    ids = torch.from_numpy(_ids(dec.cfg.vocab_size, (1, 5), seed=13))
    cache = dec.init_cache(1)
    _, out = dec.make_step(donate=False)(params, cache, ids)
    assert not cache["k"].any() and int(cache["pos"]) == 0
    assert out["k"].any() and int(out["pos"]) == 5
    _, out2 = dec.make_step(donate=True)(params, cache, ids)
    assert out2["k"] is cache["k"] and cache["k"].any()
    assert dec.make_step() is dec.make_step()
    assert dec.decode_step_fn() is dec.make_step()


def test_stage_params_match_jax(family):
    _, jdec, jparams, dec, params = family
    for first, last in ((0, 1), (1, dec.cfg.num_layers), (0, 2)):
        want = jdec.stage_params(jparams, first, last)
        got = dec.stage_params(params, first, last)
        assert sorted(got) == sorted(want)
        assert sorted(got["stack"]) == sorted(want["stack"])
        np.testing.assert_array_equal(got["stack"]["wq"].numpy(),
                                      np.asarray(want["stack"]["wq"]))
    with pytest.raises(ValueError, match="out of bounds"):
        dec.stage_params(params, 1, 1)


def test_init_and_cast_follow_the_jax_tree(family):
    _, jdec, jparams, dec, _ = family
    mine = dec.init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    bf = GptDecoder(dec.cfg, compute_dtype=torch.bfloat16, device=CPU)
    cast = bf.cast_params(mine)
    assert cast["stack"]["wq"].dtype == torch.bfloat16
    cache = bf.init_cache(3)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["k"].shape == (dec.cfg.num_layers, 3, dec.cfg.kv_heads,
                                64, dec.cfg.dim // dec.cfg.num_heads)


def test_mistral_config_is_mistral_7b():
    cfg = mistral_config()
    assert (cfg.num_layers, cfg.dim, cfg.num_heads, cfg.kv_heads,
            cfg.ffn_dim, cfg.vocab_size, cfg.window, cfg.max_len) == (
        32, 4096, 32, 8, 14336, 32000, 4096, 4096)
    from defer_tpu.models.llama import mistral_config as jax_mistral

    assert cfg.__dict__ == jax_mistral().__dict__


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_heads=4, num_kv_heads=3),
        dict(ffn_style="swiglu", num_experts=2),
        dict(window=0, causal=True),
        dict(window=8, causal=False),
        dict(capacity_factor=0.0),
        dict(num_experts=2, moe_top_k=3),
        dict(lora_rank=2, lora_targets=("w3",)),
        dict(lora_rank=2, lora_targets=()),
        dict(norm_type="batch"),
        dict(pos_style="alibi"),
    ],
)
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jts.TransformerConfig(**kw)
    with pytest.raises(ValueError):
        ts.TransformerConfig(**kw)


def test_knobs_not_ported_raise():
    with pytest.raises(NotImplementedError, match="rolling_cache"):
        GptDecoder(mistral_config(num_layers=1, dim=32, num_heads=4,
                                  num_kv_heads=2, ffn_dim=64, vocab_size=64,
                                  max_len=32, window=8),
                   rolling_cache=True, device=CPU)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="experts"):
        ts.init_stack(gen, ts.TransformerConfig(num_experts=2))
    with pytest.raises(NotImplementedError, match="LoRA"):
        ts.init_stack(gen, ts.TransformerConfig(lora_rank=2))


def test_the_decoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tiny_gpt()


def test_stack_helpers_match_jax():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 32), np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        ts._rms_norm(tx, torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jts._rms_norm(jx, jnp.asarray(scale), 1e-5)), atol=1e-5)
    np.testing.assert_allclose(
        ts._layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                       1e-5).numpy(),
        np.asarray(jts._layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                                   1e-5)), atol=1e-5)
    for pos in (np.arange(5) + 3, np.array([[0, 1, 2, 3, 4], [9, 10, 11, 12,
                                                              13]])):
        np.testing.assert_allclose(
            ts.apply_rope(tx, 8, torch.from_numpy(pos), 10000.0).numpy(),
            np.asarray(jts.apply_rope(jx, 8, jnp.asarray(pos), 10000.0)),
            atol=1e-5)
    table = rng.standard_normal((50, 16), np.float32)
    ids = rng.integers(0, 50, (2, 7))
    np.testing.assert_array_equal(
        ts.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jts.embed_lookup(jnp.asarray(table), jnp.asarray(ids))))
    qt = quantize_leaf(torch.from_numpy(table))
    np.testing.assert_allclose(
        ts.embed_lookup(qt, torch.from_numpy(ids)).numpy(),
        np.asarray(jts.embed_lookup(
            {"q": jnp.asarray(qt["q"].numpy()), "s": jnp.asarray(
                qt["s"].numpy())}, jnp.asarray(ids))), atol=1e-6)
