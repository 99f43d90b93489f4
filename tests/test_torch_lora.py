"""The port's LoRA serving half (defer_tpu_torch/parallel/lora.py, the
adapter factors of transformer_stack.init_stack and the per-slot bank
gather of GptDecoder) against the JAX package's.

Adapter trees are drawn once with numpy and given to both packages:
split/combine/merge/stack trees must equal the JAX package's, and a
multi-LoRA DecodeServer batch mixing adapters 1, 2 and the base (id 0)
must be token-identical to the JAX package's server, and equal to a
solo decode of each adapter merged into the base weights. Float32
throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import GptDecoder as JaxGptDecoder
from defer_tpu.parallel import lora as jlora
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu.runtime.decode_server import DecodeServer as JaxDecodeServer
from defer_tpu_torch import params_from_jax, params_to_numpy
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.parallel import lora
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.runtime.decode_server import DecodeServer

CPU = torch.device("cpu")
BASE = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=32, norm_style="pre", causal=True)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets=("wq", "wv", "w1", "w2"))


def _trees(seed_list):
    """Adapter trees as numpy: random a AND b factors per target."""
    cfg = ts.TransformerConfig(**BASE, **LORA)
    dims = ts.lora_target_dims(cfg)
    out = []
    for seed in seed_list:
        rng = np.random.default_rng(seed)
        st = {}
        for t in cfg.lora_targets:
            din, dout = dims[t]
            st[f"{t}:a"] = rng.standard_normal(
                (2, din, 4)).astype(np.float32) * din**-0.5
            st[f"{t}:b"] = rng.standard_normal(
                (2, 4, dout)).astype(np.float32) * 0.3
        out.append({"stack": st})
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jts.TransformerConfig(**BASE)
    jdec = JaxGptDecoder(jcfg, compute_dtype=jnp.float32)
    jbase = jdec.init(jax.random.key(0))
    dec = GptDecoder(ts.TransformerConfig(**BASE),
                     compute_dtype=torch.float32, device=CPU)
    return (dec, params_from_jax(jbase, CPU), jdec, jbase, _trees([11, 22]),
            ts.TransformerConfig(**BASE, **LORA),
            jts.TransformerConfig(**BASE, **LORA))


def _assert_trees_equal(got, want):
    """`got` a tree of the port's tensors, `want` of JAX arrays."""

    def cmp(g, w, path):
        assert g.keys() == w.keys(), path
        for k in g:
            if isinstance(g[k], dict):
                cmp(g[k], w[k], f"{path}/{k}")
            else:
                np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-6,
                                           atol=1e-6, err_msg=f"{path}/{k}")

    cmp(params_to_numpy(got), dict(want), "")


def test_lora_scale_and_dims_match_jax():
    for kw in ({}, {"lora_alpha": None}, {"lora_alpha": 2.0}):
        cfg = {**BASE, **LORA, **kw}
        assert ts.TransformerConfig(**cfg).lora_scale == \
            jts.TransformerConfig(**cfg).lora_scale
    cfg = dict(BASE, ffn_style="swiglu", num_kv_heads=2)
    assert ts.lora_target_dims(ts.TransformerConfig(**cfg)) == \
        jts.lora_target_dims(jts.TransformerConfig(**cfg))


def test_split_combine_merge_match_jax(setup):
    _, base, _, jbase, trees, cfg, jcfg = setup
    full = lora.combine_lora(base, params_from_jax(trees[0], CPU))
    jfull = jlora.combine_lora(jbase, trees[0])
    _assert_trees_equal(full, jfull)
    b, a = lora.split_lora(full)
    jb, ja = jlora.split_lora(jfull)
    _assert_trees_equal(b, jb)
    _assert_trees_equal(a, ja)
    assert all(lora.is_lora_key(k) for k in a["stack"])
    _assert_trees_equal(lora.merge_lora(full, cfg),
                        jlora.merge_lora(jfull, jcfg))


def test_stack_adapters_match_jax(setup):
    _, base, _, jbase, trees, cfg, jcfg = setup
    banked = lora.stack_adapters(base, [params_from_jax(t, CPU)
                                        for t in trees],
                                 cfg)
    jbanked = jlora.stack_adapters(jbase, trees, jcfg)
    _assert_trees_equal(banked, jbanked)
    assert banked["stack"]["wq:a"].shape == (2, 3, 32, 4)
    assert not banked["stack"]["wq:b"][:, 0].any()  # id 0: the base
    assert lora.adapter_bank_info(banked) == \
        jlora.adapter_bank_info(jbanked) == 3
    assert lora.adapter_bank_info(base) is None
    with pytest.raises(ValueError, match="unmerged"):
        lora.adapter_bank_info(lora.combine_lora(
            base, params_from_jax(trees[0], CPU)))
    with pytest.raises(ValueError, match="disagree"):
        lora.stack_adapters(base, [params_from_jax(trees[0], CPU), {
            "stack": {"wq:a": torch.zeros(2, 32, 4)}}], cfg)


def test_per_slot_adapters_match_jax_and_merged(setup):
    """Requests on adapters 1, 2, 0, 2 in one 2-slot batch: the port's
    server equals the JAX package's, and each request equals a solo
    decode of its adapter merged into the base."""
    dec, base, jdec, jbase, trees, cfg, jcfg = setup
    banked = lora.stack_adapters(base, [params_from_jax(t, CPU)
                                        for t in trees],
                                 cfg)
    jbanked = jlora.stack_adapters(jbase, trees, jcfg)
    reqs = [([3, 9, 27], 6, 1), ([5, 1], 5, 2), ([11, 2, 8], 4, 0),
            ([7], 7, 2)]
    srv = DecodeServer(dec, banked, max_batch=2)
    jsrv = JaxDecodeServer(jdec, jbanked, max_batch=2)
    assert srv.multi_lora and srv.num_adapters == 3
    rids = [srv.submit(torch.tensor([p]), s, adapter_id=a)
            for p, s, a in reqs]
    jrids = [jsrv.submit(jnp.asarray([p], jnp.int32), s, adapter_id=a)
             for p, s, a in reqs]
    done, jdone = srv.run(), jsrv.run()
    for (p, s, a), r, jr in zip(reqs, rids, jrids):
        np.testing.assert_array_equal(done[r].numpy(), np.asarray(jdone[jr]))
        solo = base if a == 0 else lora.merge_lora(
            lora.combine_lora(base, params_from_jax(trees[a - 1], CPU)), cfg)
        torch.testing.assert_close(
            done[r], dec.generate(solo, torch.tensor([p]), s),
            rtol=0, atol=0, msg=f"adapter {a}")


def test_adapter_zero_is_exact_base_and_windows(setup):
    """Every request on id 0 equals the plain server bit for bit, and a
    decode window over banked params equals decode_window=1."""
    dec, base, _, _, trees, cfg, _ = setup
    banked = lora.stack_adapters(base, [params_from_jax(t, CPU)
                                        for t in trees],
                                 cfg)
    reqs = [(torch.tensor([[3, 9, 27]]), 6), (torch.tensor([[5, 1]]), 5)]

    def serve(params, window=1, ids=(0, 0)):
        srv = DecodeServer(dec, params, max_batch=2, decode_window=window)
        rids = [srv.submit(p, s, adapter_id=a)
                for (p, s), a in zip(reqs, ids)]
        done = srv.run()
        return [done[r] for r in rids]

    for got, want in zip(serve(banked), serve(base)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(serve(banked, 4, (1, 2)), serve(banked, 1, (1, 2))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_adapter_validation(setup):
    dec, base, _, _, trees, cfg, _ = setup
    banked = lora.stack_adapters(base, [params_from_jax(t, CPU)
                                        for t in trees],
                                 cfg)
    srv = DecodeServer(dec, banked, max_batch=1)
    with pytest.raises(ValueError, match="out of range"):
        srv.submit(torch.tensor([[1]]), 2, adapter_id=3)
    with pytest.raises(ValueError, match="multi-LoRA"):
        DecodeServer(dec, banked, prefix_ids=torch.tensor([[1, 2]]))
