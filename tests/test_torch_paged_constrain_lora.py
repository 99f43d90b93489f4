"""The port's constrained decoding and multi-LoRA adapter banks on the
paged server against the JAX package's.

The same weights (the JAX package's init, carried over with
`params_from_jax`) and the compiled grammars of each package's own
compiler (tests/test_torch_constrain.py holds their tables equal) go
through `defer_tpu`'s `serve_paged` and the port's, in float32 on the
CPU. A digits regex request, a JSON-schema request and a free rider in
one batch must be token-identical to the JAX package's at decode_window
1 and 4 and at spec_k 0 and 4 (the speculative verify walks the
target's masked predictions along the proposals), every output inside
its grammar; a hand-built DFA that dead-ends must end its request with
the JAX package's error, not a hang, at spec_k 0 and 4. Three adapters
by id in one batch must equal the JAX package's multi-LoRA server, and
id 0 exactly the base model.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu import constrain as jcon
from defer_tpu.models.gpt import GptDecoder as JaxGptDecoder
from defer_tpu.models.gpt import SamplingParams as JaxSamplingParams
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.parallel import lora as jlora
from defer_tpu.parallel import transformer_stack as jts
from defer_tpu.runtime.paged import PagedDecodeServer as JaxPagedServer
from defer_tpu_torch import constrain as con
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.gpt import GptDecoder, SamplingParams, tiny_gpt
from defer_tpu_torch.parallel import lora
from defer_tpu_torch.parallel import transformer_stack as ts
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged

CPU = torch.device("cpu")
# The JAX package's constraint vocabulary (tests/test_constrain.py): id 0
# is the empty string and doubles as eos.
_CHARS = list("0123456789abcdefghijklmnopqrstuvwxyz{}[]\",:.- eE+")
VOCAB = [""] + _CHARS + ["ab", "12", '":', "},"]
VOCAB += [f"<u{i}>" for i in range(128 - len(VOCAB))]
DIGITS = "[0-9]+"
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
EOS = 0
KNOBS = dict(num_blocks=32, block_size=4, max_batch=4, eos_id=EOS)
BASE = dict(num_layers=2, dim=32, num_heads=4, ffn_dim=64, vocab_size=64,
            max_len=32, norm_style="pre", causal=True)
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets=("wq", "wv", "w1", "w2"))


def detok(ids):
    return "".join(VOCAB[int(t)] for t in np.asarray(ids).ravel())


@pytest.fixture(scope="module")
def model():
    jdec = jax_tiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    return (tiny_gpt(64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


@pytest.fixture(scope="module")
def cons():
    return ({"digits": con.compile_regex(DIGITS, VOCAB),
             "obj": con.compile_json_schema(SCHEMA, VOCAB)},
            {"digits": jcon.compile_regex(DIGITS, VOCAB),
             "obj": jcon.compile_json_schema(SCHEMA, VOCAB)})


def _trap(mod):
    """A hand-built 2-state DFA: state 0 admits one token into a trap
    that admits nothing and does not accept."""
    tr = np.full((2, 128), -1, np.int32)
    tr[0, 5] = 1
    return mod.TokenDFA(transitions=tr, accepting=np.array([False, False]),
                        pattern="<trap>")


def _serve_both(model, reqs, pcons, jcons, attention, **knobs):
    """The same constrained requests [(prompt, steps, name)] through
    both packages' paged servers; the port's outputs, the JAX package's,
    both error lists and both servers. The port's "pallas" mode runs its
    kernels' plain versions here, the JAX package's blockwise fold, so
    the JAX side runs "blockwise" there."""
    dec, params, jdec, jparams = model
    spec = knobs.pop("spec_k", 0)
    jatt = "blockwise" if attention == "pallas" else attention
    pk = dict(knobs, attention=attention)
    jk = dict(knobs, attention=jatt)
    if spec:
        pk.update(spec_k=spec, spec_draft=dec, spec_params=params)
        jk.update(spec_k=spec, spec_draft=jdec, spec_params=jparams)
    srv = PagedDecodeServer(dec, params, constraints=pcons, **pk)
    jsrv = JaxPagedServer(jdec, jparams, constraints=jcons, **jk)
    rids = [srv.submit(torch.tensor(p), s,
                       sampling=SamplingParams(constraint=n) if n else None)
            for p, s, n in reqs]
    jrids = [jsrv.submit(jnp.asarray(p, jnp.int32), s,
                         sampling=JaxSamplingParams(constraint=n)
                         if n else None)
             for p, s, n in reqs]
    done, jdone = srv.run(), jsrv.run()
    outs = [done[r].numpy() for r in rids]
    jouts = [np.asarray(jdone[r]) for r in jrids]
    errs = [srv.errors.get(r) for r in rids]
    jerrs = [jsrv.errors.get(r) for r in jrids]
    return outs, jouts, errs, jerrs, srv, jsrv


@pytest.mark.parametrize("window,spec_k,attention",
                         [(1, 0, "gathered"), (4, 0, "pallas"),
                          (1, 4, "pallas"), (4, 4, "gathered")])
def test_constrained_greedy_matches_jax(model, cons, window, spec_k,
                                        attention):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 128, size=(1, n)).tolist() for n in (3, 4, 2)]
    reqs = list(zip(prompts, [8, 16, 8], ["digits", "obj", None]))
    outs, jouts, errs, jerrs, srv, jsrv = _serve_both(
        model, reqs, *cons, attention, decode_window=window, spec_k=spec_k,
        **KNOBS)
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(got, want)
    assert errs == jerrs == [None, None, None]
    dig = detok(outs[0][0, 3:])
    assert re.fullmatch(DIGITS, dig), dig
    obj = detok(outs[1][0, 4:])
    assert json.loads(obj) in ({"ok": True}, {"ok": False}), obj
    assert srv.constrained_tokens_n == jsrv.constrained_tokens_n > 0
    assert srv.constraint_dead_ends_n == 0


@pytest.mark.parametrize("window,spec_k", [(1, 0), (4, 0), (1, 4), (4, 4)])
def test_dead_end_errors_match_jax(model, window, spec_k):
    """The trap DFA: one admissible token, then nothing. The request
    ends at its last admissible token with the JAX package's error, its
    tokens the JAX package's (the port's draft proposes eos at the dead
    state where JAX's proposes a garbage argmax; the verify accepts
    neither), and the free rider beside it is untouched."""
    dec, params, _, _ = model
    reqs = [([[3, 9, 27]], 8, "trap"), ([[5]], 6, None)]
    outs, jouts, errs, jerrs, srv, jsrv = _serve_both(
        model, reqs, {"trap": _trap(con)}, {"trap": _trap(jcon)}, "gathered",
        decode_window=window, spec_k=spec_k, **KNOBS)
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(got, want)
    assert outs[0][0, 3:].tolist() == [5]
    assert errs[0] == jerrs[0] and "dead end" in errs[0]
    assert errs[1] is None and jerrs[1] is None
    assert srv.constraint_dead_ends_n == jsrv.constraint_dead_ends_n == 1
    np.testing.assert_array_equal(
        outs[1], dec.generate(params, torch.tensor([[5]]), 6).numpy())


def test_sampled_constrained_window_equals_k1(model, cons):
    dec, params, _, _ = model
    outs = []
    for window in (1, 4):
        got, _ = serve_paged(
            dec, params, [(torch.tensor([[7, 21]]), 10)],
            sampling=[SamplingParams(temperature=0.9, seed=3,
                                     constraint="digits")],
            decode_window=window, constraints=cons[0], attention="pallas",
            **KNOBS)
        outs.append(got[0])
        assert re.fullmatch(DIGITS, detok(got[0][0, 2:]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# -- multi-LoRA ----------------------------------------------------------------

def _trees(seeds):
    """Adapter trees as numpy: random a and b factors per target."""
    cfg = ts.TransformerConfig(**BASE, **LORA)
    dims = ts.lora_target_dims(cfg)
    out = []
    for seed in seeds:
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
def banks():
    jcfg = jts.TransformerConfig(**BASE)
    jdec = JaxGptDecoder(jcfg, compute_dtype=jnp.float32)
    jbase = jdec.init(jax.random.key(0))
    dec = GptDecoder(ts.TransformerConfig(**BASE),
                     compute_dtype=torch.float32, device=CPU)
    base = params_from_jax(jbase, CPU)
    trees = _trees([11, 22, 33])
    cfg = ts.TransformerConfig(**BASE, **LORA)
    banked = lora.stack_adapters(base, [params_from_jax(t, CPU)
                                        for t in trees],
                                 cfg)
    jbanked = jlora.stack_adapters(jbase, trees,
                                   jts.TransformerConfig(**BASE, **LORA))
    return dec, base, banked, jdec, jbanked, trees, cfg


LORA_REQS = [([3, 9, 27], 6, 1), ([5, 1], 5, 2), ([11, 2, 8], 4, 0),
             ([7], 7, 3), ([4, 4, 4, 4, 4], 3, 2)]


@pytest.mark.parametrize("attention,window,chunk",
                         [("gathered", 1, None), ("pallas", 4, 3),
                          ("blockwise", 1, 3)])
def test_adapters_by_id_match_jax_and_merged(banks, attention, window,
                                             chunk):
    dec, base, banked, jdec, jbanked, trees, cfg = banks
    knobs = dict(num_blocks=24, block_size=4, max_batch=2,
                 decode_window=window, prefill_chunk=chunk)
    outs, stats = serve_paged(
        dec, banked, [(torch.tensor([p]), s) for p, s, _ in LORA_REQS],
        adapter_ids=[a for *_, a in LORA_REQS], attention=attention, **knobs)
    jouts, _ = jax_serve(jdec, jbanked, knobs,
                         "blockwise" if attention == "pallas" else attention)
    for (p, s, a), got, want in zip(LORA_REQS, outs, jouts):
        np.testing.assert_array_equal(got.numpy(), want)
        solo = base if a == 0 else lora.merge_lora(
            lora.combine_lora(base, params_from_jax(trees[a - 1], CPU)), cfg)
        torch.testing.assert_close(
            got, dec.generate(solo, torch.tensor([p]), s), rtol=0, atol=0,
            msg=f"adapter {a}")


def jax_serve(jdec, jbanked, knobs, attention):
    from defer_tpu.runtime.paged import serve_paged as jax_serve_paged

    return jax_serve_paged(
        jdec, jbanked,
        [(jnp.asarray([p], jnp.int32), s) for p, s, _ in LORA_REQS],
        adapter_ids=[a for *_, a in LORA_REQS], attention=attention,
        **knobs)


def test_adapter_zero_is_exactly_the_base(banks):
    dec, base, banked, *_ = banks
    reqs = [(torch.tensor([p]), s) for p, s, _ in LORA_REQS]
    for window in (1, 4):
        got, _ = serve_paged(dec, banked, reqs, num_blocks=24, block_size=4,
                             max_batch=2, attention="pallas",
                             decode_window=window)
        want, _ = serve_paged(dec, base, reqs, num_blocks=24, block_size=4,
                              max_batch=2, attention="pallas",
                              decode_window=window)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_adapter_validation(banks):
    dec, base, banked, *_ = banks
    srv = PagedDecodeServer(dec, banked, num_blocks=8, block_size=4)
    assert srv.multi_lora and srv.num_adapters == 4
    with pytest.raises(ValueError, match="out of range"):
        srv.submit(torch.tensor([[1]]), 2, adapter_id=4)
    with pytest.raises(ValueError, match="base model only"):
        srv.submit_prefilled(np.ones((1, 2), np.int32), 2)
    for kw, match in ((dict(prefix_cache=True), "prefix_cache"),
                      (dict(prefix_ids=torch.zeros((1, 4), dtype=torch.long)),
                       "prefix"),
                      (dict(spec_k=1, spec_draft=dec, spec_params=base),
                       "multi-LoRA")):
        with pytest.raises(ValueError, match=match):
            PagedDecodeServer(dec, banked, num_blocks=8, block_size=4, **kw)
    plain = PagedDecodeServer(dec, base, num_blocks=8, block_size=4)
    with pytest.raises(ValueError, match="adapter banks"):
        plain.submit(torch.tensor([[1]]), 2, adapter_id=1)
