"""The port's T5 (defer_tpu_torch/models/t5.py) against the JAX package's
(defer_tpu/models/t5.py), mirroring tests/test_t5.py.

The same numpy-seeded inputs and the same weights (the JAX package's
random init carried over with `params_from_jax`) go through both
packages in float32 on the CPU: encoder outputs, teacher-forced logits
and the cached step's logits within 2e-5 abs + 2e-4 rel of JAX's (f32
roundoff of the two packages' matmul orders), greedy generation
token-identical, and the bucket function equal on a grid. The rest
mirrors the JAX file on the port alone: config validation, the prefill
overflow guard, the cached step against teacher forcing, eos pinning,
cross K/V computed once, pad masks. `from_hf_state_dict` is held against
transformers' `T5ForConditionalGeneration` forward (2e-4 abs + 2e-3
rel, as in the JAX file) and skips without transformers. The
tensor-parallel tests of the JAX file (`SpmdT5`) run over ranks in
tests/test_torch_spmd_t5.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models import t5 as jt5
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.t5 import (
    T5,
    T5Config,
    from_hf_state_dict,
    relative_position_bucket,
    t5_config,
    tiny_t5,
)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)
HF_TOL = dict(rtol=2e-3, atol=2e-4)


def _pair(**overrides):
    """(port model, port params, JAX model, JAX params) on one init."""
    jm = jt5.tiny_t5(**overrides)
    jparams = jm.init(jax.random.key(0))
    return (tiny_t5(device=CPU, **overrides), params_from_jax(jparams, CPU),
            jm,
            jparams)


def _ids(seed, shape, lo=0, hi=96):
    return np.random.default_rng(seed).integers(lo, hi, size=shape)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def test_config_validation():
    with pytest.raises(ValueError, match="ffn_style"):
        T5Config(ffn_style="swiglu")
    with pytest.raises(ValueError, match="rel_buckets"):
        T5Config(rel_buckets=7)
    with pytest.raises(ValueError, match="rel_max_distance"):
        T5Config(rel_buckets=32, rel_max_distance=16)
    assert t5_config("base") == T5Config(**{
        f: getattr(jt5.t5_config("base"), f)
        for f in T5Config.__dataclass_fields__})
    with pytest.raises(KeyError):
        t5_config("xxl-imagined")


def test_no_card_no_fallback():
    """A T5 built without device= runs on the card and raises without
    one; it never drops to the CPU on its own."""
    if torch.cuda.is_available():
        assert T5(T5Config()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T5(T5Config())


def test_prefill_guards_cache_overflow():
    m, params, _, _ = _pair()
    enc_out = m.encode(params, torch.zeros((1, 4), dtype=torch.int64))
    cache = m.start_cache(params, enc_out)
    _, cache = m.prefill(
        params, cache, torch.zeros((1, m.cfg.max_len - 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="max_len"):
        m.prefill(params, cache, torch.zeros((1, 3), dtype=torch.int64))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,dist", [(32, 128), (8, 20)])
def test_bucket_equals_the_jax_package(bidirectional, buckets, dist):
    """Bucket for bucket on a grid of relative positions, both modes."""
    rel = np.arange(-300, 300).reshape(3, -1)
    got = relative_position_bucket(torch.from_numpy(rel),
                                   bidirectional=bidirectional,
                                   num_buckets=buckets, max_distance=dist)
    want = jt5.relative_position_bucket(jnp.asarray(rel),
                                        bidirectional=bidirectional,
                                        num_buckets=buckets,
                                        max_distance=dist)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucket_properties():
    rel = torch.arange(-40, 41)
    b_bi = relative_position_bucket(rel, bidirectional=True,
                                    num_buckets=32, max_distance=128)
    b_ca = relative_position_bucket(rel, bidirectional=False,
                                    num_buckets=32, max_distance=128)
    assert int(b_bi[40]) == 0 and int(b_ca[40]) == 0
    assert ((b_bi >= 0) & (b_bi < 32)).all()
    assert ((b_ca >= 0) & (b_ca < 32)).all()
    neg, pos = b_bi[:40].numpy(), b_bi[41:].numpy()
    assert set(neg).isdisjoint(set(pos))
    assert (b_ca[41:] == 0).all()
    assert (np.diff(neg) <= 0).all()


@pytest.mark.parametrize("overrides", [
    {}, {"ffn_style": "gated-gelu", "tie_word_embeddings": False},
    {"num_decoder_layers": 3},
], ids=["v1.0", "v1.1", "deeper_decoder"])
def test_encode_and_forward_match_jax(overrides):
    m, params, jm, jparams = _pair(**overrides)
    enc, dec = _ids(1, (2, 7)), _ids(2, (2, 5))
    np.testing.assert_allclose(
        m.encode(params, _t(enc)).numpy(),
        np.asarray(jm.encode(jparams, _j(enc))), **TOL)
    logits = m.forward(params, _t(enc), _t(dec))
    assert logits.shape == (2, 5, 96) and torch.isfinite(logits).all()
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jm.forward(jparams, _j(enc), _j(dec))),
        **TOL)


def test_incremental_decode_matches_teacher_forcing():
    """The cached step reproduces the teacher-forced decoder position by
    position, and JAX's cached step."""
    m, params, jm, jparams = _pair()
    enc, dec = _ids(1, (2, 7)), _ids(2, (2, 9))
    enc_out = m.encode(params, _t(enc))
    want = m.decode_logits(params, enc_out, _t(dec))
    step = m.make_step(donate=False)
    cache = m.start_cache(params, enc_out)
    logits, cache = step(params, cache, _t(dec[:, :4]))
    outs = [logits]
    for t in range(4, 9):
        logits, cache = step(params, cache, _t(dec[:, t:t + 1]))
        outs.append(logits)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jenc = jm.encode(jparams, _j(enc))
    jcache = jm.start_cache(jparams, jenc)
    jstep = jm.make_step(donate=False)
    jl, jcache = jstep(jparams, jcache, _j(dec[:, :4]))
    jouts = [jl]
    for t in range(4, 9):
        jl, jcache = jstep(jparams, jcache, _j(dec[:, t:t + 1]))
        jouts.append(jl)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnp.concatenate(jouts, 1)), **TOL)


def test_incremental_decode_gated_untied():
    m, params, _, _ = _pair(ffn_style="gated-gelu", tie_word_embeddings=False)
    assert "lm_head" in params and "w3" in params["dec_stack"]
    enc, dec = _ids(1, (1, 6)), _ids(2, (1, 6))
    enc_out = m.encode(params, _t(enc))
    want = m.decode_logits(params, enc_out, _t(dec))
    step = m.make_step(donate=False)
    cache = m.start_cache(params, enc_out)
    outs = []
    for t in range(6):
        logits, cache = step(params, cache, _t(dec[:, t:t + 1]))
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(),
                               **TOL)


def test_donating_step_writes_in_place():
    """donate=True writes the new rows into the given buffers (the
    serving configuration); donate=False leaves them untouched."""
    m, params, _, _ = _pair()
    enc_out = m.encode(params, _t(_ids(1, (1, 5))))
    cache = m.start_cache(params, enc_out)
    k0 = cache["k"].clone()
    _, out = m.make_step(donate=False)(params, cache, _t([[3, 4]]))
    assert torch.equal(cache["k"], k0) and int(out["pos"]) == 2
    _, out = m.make_step()(params, cache, _t([[3, 4]]))
    assert out["k"] is cache["k"] and not torch.equal(cache["k"], k0)


def test_generate_matches_jax_greedy():
    """Greedy generation is token-identical to the JAX package's, and
    deterministic."""
    m, params, jm, jparams = _pair()
    enc = _ids(5, (2, 6), lo=1)
    a = m.generate(params, _t(enc), 10)
    b = m.generate(params, _t(enc), 10)
    assert a.shape == (2, 11)
    assert int(a[0, 0]) == m.cfg.decoder_start_token_id
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jm.generate(jparams, _j(enc), 10)))
    with pytest.raises(ValueError, match="max_len"):
        m.generate(params, _t(enc), m.cfg.max_len)


def test_generate_stops_at_eos():
    m, params, _, _ = _pair()
    enc = _ids(1, (2, 6), lo=1)
    free = m.generate(params, _t(enc), 8).numpy()
    eos = int(free[0, 3])
    out = m.generate(params, _t(enc), 8, eos_id=eos).numpy()
    assert out.shape == free.shape
    for b in range(2):
        gen_free = free[b, 1:]
        hits = np.where(gen_free == eos)[0]
        cut = hits[0] if len(hits) else len(gen_free) - 1
        np.testing.assert_array_equal(out[b, 1:1 + cut + 1],
                                      gen_free[:cut + 1])
        if len(hits):
            assert (out[b, 1 + cut:] == eos).all()


def test_cross_kv_precomputed_once():
    """start_cache holds every decoder layer's cross K/V; the step never
    reads ck again (zeroing it changes nothing once the cache exists)."""
    m, params, _, _ = _pair()
    enc_out = m.encode(params, _t(_ids(1, (1, 5))))
    cache = m.start_cache(params, enc_out)
    assert cache["cross_k"].shape == (m.cfg.dec_layers, 1, m.cfg.num_heads,
                                      5, m.cfg.head_dim)
    step = m.make_step(donate=False)
    ids = torch.zeros((1, 1), dtype=torch.int64)
    want, _ = step(params, cache, ids)
    broken = {**params, "dec_stack": {**params["dec_stack"],
                                      "ck": torch.zeros_like(
                                          params["dec_stack"]["ck"])}}
    got, _ = step(broken, cache, ids)
    assert torch.equal(got, want)


def test_all_pad_row_stays_finite():
    m, params, jm, jparams = _pair()
    enc = _ids(1, (2, 5), lo=1)
    dec = np.zeros((2, 3), np.int64)
    mask = np.asarray([[0, 0, 0, 0, 0], [1, 1, 1, 0, 0]])
    logits = m.forward(params, _t(enc), _t(dec), enc_mask=_t(mask))
    assert torch.isfinite(logits).all()
    want = m.forward(params, _t(enc[1:]), _t(dec[1:]),
                     enc_mask=_t(mask[1:]))
    np.testing.assert_allclose(logits[1:].numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(jm.forward(jparams, _j(enc), _j(dec),
                              enc_mask=_j(mask))), **TOL)


def test_enc_mask_matches_unpadded_run():
    m, params, _, _ = _pair()
    real = _ids(1, (1, 5), lo=1)
    want = m.generate(params, _t(real), 6)
    padded = np.concatenate([real, np.zeros((1, 4), real.dtype)], axis=1)
    mask = np.concatenate([np.ones((1, 5)), np.zeros((1, 4))], 1)
    got = m.generate(params, _t(padded), 6, enc_mask=_t(mask))
    assert torch.equal(got, want)
    dec = torch.zeros((1, 3), dtype=torch.int64)
    with_mask = m.forward(params, _t(padded), dec, enc_mask=_t(mask))
    without = m.forward(params, _t(padded), dec)
    assert not torch.allclose(with_mask, without, atol=1e-5)


def test_cast_params_and_bf16_forward():
    """cast_params re-stores float leaves in the compute dtype; a bf16
    model runs its forward in bf16 with f32 logits."""
    m = T5(tiny_t5(device=CPU).cfg, compute_dtype=torch.bfloat16,
           device=CPU)
    params = m.cast_params(m.init(torch.Generator().manual_seed(0)))
    assert params["dec_stack"]["wq"].dtype == torch.bfloat16
    logits = m.forward(params, _t(_ids(1, (1, 6))), _t(_ids(2, (1, 4))))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


# -- HuggingFace transformers -------------------------------------------------


def _hf(seed, **cfg):
    transformers = pytest.importorskip("transformers")
    base = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                num_heads=4, relative_attention_num_buckets=8,
                relative_attention_max_distance=20, dropout_rate=0.0,
                feed_forward_proj="relu", tie_word_embeddings=True,
                decoder_start_token_id=0)
    base.update(cfg)
    torch.manual_seed(seed)
    return transformers.T5ForConditionalGeneration(
        transformers.T5Config(**base)).eval()


def test_hf_t5_bucket_parity():
    pytest.importorskip("transformers")
    from transformers.models.t5.modeling_t5 import T5Attention

    rel = torch.arange(-300, 301).reshape(1, -1)
    for bidirectional in (True, False):
        want = T5Attention._relative_position_bucket(
            rel, bidirectional=bidirectional, num_buckets=32,
            max_distance=128)
        got = relative_position_bucket(rel, bidirectional=bidirectional,
                                       num_buckets=32, max_distance=128)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_hf_t5_parity():
    hf = _hf(0)
    m = tiny_t5(device=CPU)
    params = from_hf_state_dict(m.cfg, hf.state_dict(), device=CPU)
    assert "lm_head" not in params
    enc, dec = _ids(0, (2, 7)), _ids(1, (2, 5))
    with torch.no_grad():
        enc_want = hf.encoder(input_ids=_t(enc)).last_hidden_state
        want = hf(input_ids=_t(enc), decoder_input_ids=_t(dec)).logits
        np.testing.assert_allclose(m.encode(params, _t(enc)).numpy(),
                                   enc_want.numpy(), **HF_TOL)
        np.testing.assert_allclose(
            m.forward(params, _t(enc), _t(dec)).numpy(), want.numpy(),
            **HF_TOL)


def test_hf_transplant_defaults_to_the_card():
    """No device: the first CUDA device (the JAX package's default
    device); with no card the call raises naming the CPU opt-in."""
    hf = _hf(0)
    cfg = tiny_t5(device=CPU).cfg
    if torch.cuda.is_available():
        params = from_hf_state_dict(cfg, hf.state_dict())
        assert params["token_embedding"].device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_hf_state_dict(cfg, hf.state_dict())


def test_hf_transplant_tie_mismatch_is_loud():
    hf = _hf(3, tie_word_embeddings=False)
    with pytest.raises(ValueError, match="tie_word_embeddings"):
        from_hf_state_dict(tiny_t5(device=CPU).cfg, hf.state_dict(),
                           device=CPU)
    tied = _hf(3)
    with pytest.raises(ValueError, match="tie_word_embeddings"):
        from_hf_state_dict(tiny_t5(device=CPU,
                                   tie_word_embeddings=False).cfg,
                           tied.state_dict(), device=CPU)


def test_hf_t5_masked_parity():
    hf = _hf(2)
    m = tiny_t5(device=CPU)
    params = from_hf_state_dict(m.cfg, hf.state_dict(), device=CPU)
    enc = _ids(3, (2, 8), lo=1)
    enc[0, 5:] = 0
    mask = np.ones((2, 8), np.int64)
    mask[0, 5:] = 0
    dec = _ids(4, (2, 4))
    with torch.no_grad():
        want = hf(input_ids=_t(enc), attention_mask=_t(mask),
                  decoder_input_ids=_t(dec)).logits
        got = m.forward(params, _t(enc), _t(dec), enc_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HF_TOL)


def test_hf_t5_v11_parity():
    hf = _hf(1, feed_forward_proj="gated-gelu", tie_word_embeddings=False)
    m = tiny_t5(device=CPU, ffn_style="gated-gelu",
                tie_word_embeddings=False)
    params = from_hf_state_dict(m.cfg, hf.state_dict(), device=CPU)
    assert "lm_head" in params
    enc, dec = _ids(1, (2, 6)), _ids(2, (2, 4))
    with torch.no_grad():
        want = hf(input_ids=_t(enc), decoder_input_ids=_t(dec)).logits
        got = m.forward(params, _t(enc), _t(dec))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HF_TOL)


def test_hf_greedy_generate_matches():
    """The port's cached greedy decode gives transformers' greedy
    tokens on the transplanted weights."""
    hf = _hf(4)
    m = tiny_t5(device=CPU)
    params = from_hf_state_dict(m.cfg, hf.state_dict(), device=CPU)
    enc = _ids(6, (2, 6), lo=1)
    hf.generation_config.eos_token_id = None  # no early stop: 8 tokens
    with torch.no_grad():
        want = hf.generate(input_ids=_t(enc), max_new_tokens=8,
                           do_sample=False, num_beams=1)
    got = m.generate(params, _t(enc), 8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
