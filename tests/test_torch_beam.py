"""The port's beam search (defer_tpu_torch/models/beam.py) against the
JAX package's: on the same weights (the JAX package's init, carried over
with `params_from_jax`) and prompt, the beams must be identical
sequences, best first, with scores within 1e-4 of JAX's; beam 1 is
greedy `generate`, and a wider beam never scores below greedy. Float32
on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models import beam as jbeam
from defer_tpu.models import gpt as jgpt
from defer_tpu.models.llama import mistral_config as jax_mistral_config
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.beam import beam_search
from defer_tpu_torch.models.gpt import GptDecoder, tiny_gpt
from defer_tpu_torch.models.llama import mistral_config, tiny_llama

CPU = torch.device("cpu")
JAX = {"gpt": jgpt.tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}


def _make(family):
    jdec = JAX[family](64)
    jparams = jdec.init(jax.random.key(0))
    return (PORT[family](64, device=CPU), params_from_jax(jparams, CPU),
            jdec, jparams)


@pytest.mark.parametrize("family,beam,penalty", [
    ("gpt", 4, 0.0), ("llama", 3, 0.0), ("gpt", 4, 0.7)])
def test_beams_match_jax(family, beam, penalty):
    dec, params, jdec, jparams = _make(family)
    prompt = [[5, 2, 9]]
    ids, scores = beam_search(dec, params, torch.tensor(prompt), 6,
                              beam_size=beam, length_penalty=penalty)
    jids, jscores = jbeam.beam_search(jdec, jparams,
                                      jnp.asarray(prompt, jnp.int32), 6,
                                      beam_size=beam, length_penalty=penalty)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=0, atol=1e-4)
    assert ids.shape == (beam, 9)
    assert len({tuple(r) for r in ids.tolist()}) == beam
    assert (np.diff(scores.numpy()) <= 1e-6).all()


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_beam1_is_greedy_and_wider_never_worse(family):
    dec, params, _, _ = _make(family)
    prompt = torch.tensor([[3, 7, 1]])
    greedy = dec.generate(params, prompt, 8)
    got, _ = beam_search(dec, params, prompt, 8, beam_size=1)
    torch.testing.assert_close(got, greedy, rtol=0, atol=0)
    logp = torch.log_softmax(dec.reference_logits(params, greedy[:, :-1]), -1)
    g_score = sum(float(logp[0, t - 1, greedy[0, t]]) for t in range(3, 11))
    ids, scores = beam_search(dec, params, prompt, 8, beam_size=4)
    assert float(scores[0]) >= g_score - 1e-4
    logp = torch.log_softmax(dec.reference_logits(params, ids[:1, :-1]), -1)
    best = sum(float(logp[0, t - 1, ids[0, t]]) for t in range(3, 11))
    assert float(scores[0]) == pytest.approx(best, abs=1e-4)


def test_beam_on_rolling_cache_matches_jax():
    """A rolling decoder past its window: the prompt chunks through
    prefill, and the beams equal the JAX package's."""
    shape = dict(num_layers=2, dim=64, num_heads=4, num_kv_heads=2,
                 ffn_dim=128, vocab_size=96, max_len=32, window=4)
    jdec = jgpt.GptDecoder(jax_mistral_config(**shape),
                           compute_dtype=jnp.float32, rolling_cache=True)
    jparams = jdec.init(jax.random.key(0))
    dec = GptDecoder(mistral_config(**shape), compute_dtype=torch.float32,
                     rolling_cache=True, device=CPU)
    params = params_from_jax(jparams, CPU)
    prompt = np.random.default_rng(1).integers(0, 96, size=(1, 7))
    ids, scores = beam_search(dec, params, torch.from_numpy(prompt), 6,
                              beam_size=3)
    jids, jscores = jbeam.beam_search(jdec, jparams, jnp.asarray(prompt), 6,
                                      beam_size=3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0,
                               atol=1e-4)


def test_beam_validation():
    dec = tiny_gpt(16, device=CPU)
    params = dec.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="one prompt"):
        beam_search(dec, params, torch.zeros((2, 3), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(dec, params, torch.zeros((1, 3), dtype=torch.long), 2,
                    beam_size=0)
    with pytest.raises(ValueError, match="max_len"):
        beam_search(dec, params, torch.zeros((1, 10), dtype=torch.long), 10)
