"""The port's packed token feed (defer_tpu_torch/runtime/text_data.py,
its own numpy copy) against the JAX package's: the same documents and
seed give the same windows and blocks, element for element, and the
same refusals; its blocks drive the port's LM train step.
"""

import functools

import numpy as np
import pytest
import torch

from defer_tpu.runtime import text_data as jtd
from defer_tpu_torch.models.bert import SpmdBert
from defer_tpu_torch.parallel import mesh, train
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
from defer_tpu_torch.runtime import text_data as td

EOS = 99


def _docs(seed=0, n=40, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 90, size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("seq_len,drop", [(4, True), (7, False), (16, True)])
def test_pack_documents_matches_jax(seq_len, drop):
    docs = _docs(1, n=12)
    got = list(td.pack_documents(docs, seq_len, eos_id=EOS,
                                 drop_remainder=drop))
    want = list(jtd.pack_documents(docs, seq_len, eos_id=EOS,
                                   drop_remainder=drop))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert td.token_count(docs) == jtd.token_count(docs)


@pytest.mark.parametrize("seed,epochs", [(0, 1), (7, 2), (8, 3)])
def test_lm_batches_give_the_jax_packages_windows(seed, epochs):
    docs = _docs()
    kw = dict(seq_len=16, batch=2, num_microbatches=3, eos_id=EOS,
              seed=seed, epochs=epochs)
    got = list(td.lm_batches(docs, **kw))
    want = list(jtd.lm_batches(docs, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == (3, 2, 16) and a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_refusals_match_jax():
    cases = [
        (lambda m: list(m.pack_documents([[1]], 1, eos_id=EOS)), "seq_len"),
        (lambda m: list(m.pack_documents([np.zeros((2, 2))], 4, eos_id=EOS)),
         "1-D"),
        (lambda m: list(m.lm_batches([[1, 2, 3]], seq_len=16, batch=4,
                                     num_microbatches=4, eos_id=EOS)),
         "add documents"),
        (lambda m: list(m.lm_batches([], seq_len=16, batch=4,
                                     num_microbatches=4, eos_id=EOS)),
         "no documents"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match) as jerr:
            call(jtd)
        with pytest.raises(ValueError, match=match) as err:
            call(td)
        assert str(err.value) == str(jerr.value)


def test_lm_batches_feed_the_train_step():
    """The blocks drive make_lm_train_step directly and the model learns
    a memorizable corpus."""
    cfg = TransformerConfig(num_layers=2, dim=32, num_heads=4, ffn_dim=64,
                            vocab_size=100, max_len=16, norm_style="pre",
                            causal=True)
    cpu = torch.device("cpu")
    sb = SpmdBert(mesh.make_mesh({"stage": 2}, [cpu, cpu]), cfg,
                  compute_dtype=torch.float32)
    init, step = train.make_lm_train_step(
        sb, functools.partial(torch.optim.Adam, lr=1e-2))
    state = init(torch.Generator().manual_seed(0))
    docs = [list(range(i, i + 10)) for i in range(0, 80, 10)]
    block = next(td.lm_batches(docs, seq_len=16, batch=2, num_microbatches=2,
                               eos_id=EOS, seed=0))
    losses = [float(step(state, torch.from_numpy(block))[1])
              for _ in range(20)]
    assert losses[-1] < 0.5 * losses[0], losses
