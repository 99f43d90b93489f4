"""The port's paged speculative decoding (PagedDecodeServer(spec_k=k))
against the JAX package's and against the port's own spec_k=0.

Target and drafts carry the JAX package's init over with
`params_from_jax` (float32, on the CPU, where the port's "pallas" mode
runs its kernels' plain versions: the JAX package's blockwise fold, so
it is held against JAX "blockwise"). Greedy output must be
token-identical to the JAX package's speculative server with the same
knobs and to spec_k=0, and the acceptance, proposal, round and dispatch
counts must equal the JAX package's: at k 1, 3 and 4, with a self-draft
(every proposal accepted), a 1-layer draft and a divergent draft (most
rejected), and in a speculative window (decode_window=4: whole rounds in
one dispatch; on the CPU its body runs eagerly, tests/test_torch_cuda.py
holds the captured graph to it). Sampled slots ride the verify's row 0
and must equal spec_k=0's streams. Eos and stop sequences inside a round
truncate where the sequential loop stops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu import obs as jax_obs
from defer_tpu.models.gpt import GptDecoder as JaxGptDecoder
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import obs, params_from_jax
from defer_tpu_torch.models.gpt import GptDecoder, SamplingParams, tiny_gpt
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged

CPU = torch.device("cpu")
KNOBS = dict(num_blocks=24, block_size=8, max_batch=2)
SPEC_STATS = ("spec_rounds", "spec_proposed", "spec_accepted",
              "spec_acceptance", "spec_draft_tokens", "ticks",
              "host_dispatches", "tokens_per_dispatch", "peak_blocks",
              "prefill_tokens_saved")
ROUNDS = 'defer_spec_rounds_total{server="paged"}'
ROWS_BASE = 'defer_kv_rows_gathered_baseline_total{server="paged"}'


def _pair(layers=None, seed=0):
    """(port decoder, port params, JAX decoder, JAX params): tiny_gpt(64),
    or a `layers`-deep copy of its config, from JAX key `seed`."""
    jdec = jax_tiny_gpt(64)
    dec = tiny_gpt(64, device=CPU)
    if layers is not None:
        jdec = JaxGptDecoder(dataclasses.replace(jdec.cfg, num_layers=layers),
                             compute_dtype=jnp.float32)
        dec = GptDecoder(dataclasses.replace(dec.cfg, num_layers=layers),
                         compute_dtype=torch.float32, device=CPU)
    jparams = jdec.init(jax.random.key(seed))
    return dec, params_from_jax(jparams, CPU), jdec, jparams


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(), "small": _pair(1, 3),
            "divergent": _pair(seed=7)}


def _requests(vocab=128):
    """The JAX package's mix (tests/test_spec_paged.py): a shared 8-token
    prefix on the first two (a radix hit under prefix_cache), lengths
    across block boundaries, a one-token prompt."""
    rng = np.random.default_rng(11)
    base = rng.integers(1, vocab, size=(1, 8))
    ext = rng.integers(1, vocab, size=(1, 3))
    return [(base, 6), (np.concatenate([base, ext], axis=1), 5),
            (rng.integers(1, vocab, size=(1, 1)), 7),
            (rng.integers(1, vocab, size=(1, 5)), 4)]


def _run(models, draft, port=True, **knobs):
    """serve_paged of the mix in either package, with `draft` ("self",
    "small", "divergent" or None) proposing."""
    dec, params, jdec, jparams = models["target"]
    if draft is not None:
        d = models["target"] if draft == "self" else models[draft]
        knobs.update(spec_draft=d[0] if port else d[2],
                     spec_params=d[1] if port else d[3])
    if port:
        reqs = [(torch.tensor(p), s) for p, s in _requests()]
        with obs.counter_deltas() as delta:
            outs, stats = serve_paged(dec, params, reqs, **knobs)
        return [o.numpy() for o in outs], stats, delta
    reqs = [(jnp.asarray(p, jnp.int32), s) for p, s in _requests()]
    with jax_obs.counter_deltas() as delta:
        outs, stats = jax_serve_paged(jdec, jparams, reqs, **knobs)
    return [np.asarray(o) for o in outs], stats, delta


def _same(outs, want, msg=""):
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got, ref, err_msg=msg)


@pytest.mark.parametrize(
    "k,attention,prefix_cache,draft,window",
    [(1, "gathered", False, "small", 1), (3, "pallas", True, "small", 1),
     (4, "gathered", True, "self", 1), (4, "pallas", False, "small", 1),
     (3, "blockwise", False, "divergent", 1),
     (4, "pallas", True, "small", 4), (3, "gathered", False, "self", 4)],
)
def test_spec_matches_jax_and_spec_k0(models, k, attention, prefix_cache,
                                      draft, window):
    knobs = dict(KNOBS, attention=attention, prefix_cache=prefix_cache,
                 decode_window=window)
    outs, stats, d = _run(models, draft, spec_k=k, **knobs)
    base, _, _ = _run(models, None, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats, jd = _run(models, draft, port=False, spec_k=k,
                             **dict(knobs, attention=jatt))
    msg = f"k={k} {attention} prefix_cache={prefix_cache} {draft} K={window}"
    _same(outs, jouts, msg)
    _same(outs, base, msg)
    for key in SPEC_STATS:
        assert stats[key] == jstats[key], (key, msg)
    assert stats["spec_k"] == k and stats["spec_rounds"] > 0
    assert d[ROUNDS] == jd[ROUNDS] == stats["spec_rounds"]
    assert d[ROWS_BASE] == jd[ROWS_BASE]
    if draft == "self":
        assert stats["spec_acceptance"] == 1.0
    if draft == "divergent":
        assert stats["spec_acceptance"] < 0.5


def test_self_draft_dispatch_amortization(models):
    """One request, a self-draft at k=4: 9 tokens are the admission's
    first token plus two rounds of 5, in 4 dispatches."""
    dec, params, _, _ = models["target"]
    outs, stats = serve_paged(dec, params, [(torch.tensor([[3, 9, 27]]), 9)],
                              num_blocks=16, block_size=8, max_batch=2,
                              spec_draft=dec, spec_params=params, spec_k=4)
    assert stats["spec_acceptance"] == 1.0
    assert stats["spec_rounds"] == 2 and stats["host_dispatches"] == 4
    torch.testing.assert_close(
        outs[0], dec.generate(params, torch.tensor([[3, 9, 27]]), 9),
        rtol=0, atol=0)


@pytest.mark.parametrize("window", [1, 4])
def test_sampled_slots_ride_row_zero(models, window):
    """Greedy and sampled slots in one batch: the sampled streams equal
    spec_k=0's (one draw a round from the verify's row 0)."""
    dec, params, _, _ = models["target"]
    sdec, sparams, _, _ = models["small"]
    reqs = [(torch.tensor(p), s) for p, s in _requests()]
    samps = [None, SamplingParams(temperature=0.9, seed=13), None,
             SamplingParams(temperature=1.0, top_k=8, seed=5)]
    base, _ = serve_paged(dec, params, reqs, sampling=samps, **KNOBS)
    outs, stats = serve_paged(dec, params, reqs, sampling=samps,
                              spec_draft=sdec, spec_params=sparams, spec_k=3,
                              decode_window=window, attention="pallas",
                              **KNOBS)
    _same([o.numpy() for o in outs], [b.numpy() for b in base])
    assert stats["spec_rounds"] > 0


@pytest.mark.parametrize("window", [1, 4])
def test_eos_and_stop_mid_round(models, window):
    dec, params, jdec, jparams = models["target"]
    prompt = [[11, 2, 8, 1, 6]]
    toks = dec.generate(params, torch.tensor(prompt), 9)[0].tolist()
    eos = toks[5 + 3]
    for kw in ({"eos_id": eos}, {"stop": [[toks[5 + 2], toks[5 + 3]]]}):
        stop = kw.pop("stop", None)
        got = []
        for spec in (0, 4):
            srv = PagedDecodeServer(
                dec, params, num_blocks=16, block_size=8, max_batch=1,
                decode_window=window if spec else 1,
                **(dict(spec_draft=dec, spec_params=params, spec_k=spec)
                   if spec else {}), **kw)
            rid = srv.submit(torch.tensor(prompt), 9, stop=stop)
            got.append(srv.run()[rid][0].tolist())
        assert got[0] == got[1]
        assert len(got[1]) < 5 + 9
    # The eos case against the JAX package's speculative server.
    jouts, _ = jax_serve_paged(
        jdec, jparams, [(jnp.asarray(prompt, jnp.int32), 9)], num_blocks=16,
        block_size=8, max_batch=1, eos_id=eos, spec_draft=jdec,
        spec_params=jparams, spec_k=4, decode_window=window)
    outs, _ = serve_paged(
        dec, params, [(torch.tensor(prompt), 9)], num_blocks=16,
        block_size=8, max_batch=1, eos_id=eos, spec_draft=dec,
        spec_params=params, spec_k=4, decode_window=window)
    _same([outs[0].numpy()], [np.asarray(jouts[0])])


def test_spec_validation(models):
    dec, params, _, _ = models["target"]
    base = dict(num_blocks=16, block_size=8, max_batch=2)
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        PagedDecodeServer(dec, params, spec_k=-1, **base)
    with pytest.raises(ValueError, match="spec_k >= 1"):
        PagedDecodeServer(dec, params, spec_draft=dec, **base)
    short = tiny_gpt(32, device=CPU)
    with pytest.raises(ValueError, match="max_len"):
        PagedDecodeServer(dec, params, spec_draft=short, spec_params=params,
                          spec_k=2, **base)
    srv = PagedDecodeServer(dec, params, spec_draft=dec, spec_params=params,
                            spec_k=4, **base)
    with pytest.raises(ValueError, match="spec_k"):
        srv.submit(torch.zeros((1, 8), dtype=torch.long), 56)
    with pytest.raises(ValueError, match="spec_k"):
        srv.submit_prefilled(np.ones((1, 8), np.int32), 56)
    assert srv.submit_prefilled(np.ones((1, 8), np.int32), 4) >= 0
