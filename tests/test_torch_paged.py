"""The port's paged KV server against the JAX package's.

The same requests and weights (the JAX package's random init, carried
over with `params_from_jax`) go through `defer_tpu`'s `serve_paged` and
the port's, in float32 on the CPU: greedy outputs must be token-identical
and the pool accounting equal (ticks, peak blocks, prefix hits, prefill
tokens saved, the `defer_kv_rows_*` counters) across attention x
prefix_cache x prefill_chunk. The port's "pallas" mode runs its kernels'
plain versions here, the JAX package's `_blockwise_attend(_mt)` fold, so
it is held against JAX "blockwise" (the same fold; JAX's own "pallas"
server runs its kernels in interpret mode, which one case pays for, to
pin the per-slot row counters). `PrefixBlockCache` must give the JAX
class's digests and decisions. Sampled slots are held against the
port's solo `generate` with the same seed (torch and JAX generators
differ). The knobs the port leaves out raise NotImplementedError (the
int8 pool and the spill tier: tests/test_torch_kv_quant.py; windows,
mixed ticks, speculation, constraints, LoRA and disagg: the
test_torch_paged_*.py, test_torch_mixed.py and test_torch_disagg.py
files).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu import obs as jax_obs
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.models.llama import tiny_llama as jax_tiny_llama
from defer_tpu.runtime.paged import PrefixBlockCache as JaxPrefixBlockCache
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import obs, params_from_jax
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.parallel.mesh import make_mesh
from defer_tpu_torch.runtime.paged import (
    PagedDecodeServer,
    PrefixBlockCache,
    serve_paged,
)

CPU = torch.device("cpu")
JAX = {"gpt": jax_tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}
# Requests 0, 1 and 4 share their first full blocks at block_size 4.
PROMPTS = [([3, 9, 27, 4, 1, 8, 2, 6, 5], 7),
           ([3, 9, 27, 4, 1, 8, 2, 6, 11, 2], 4),
           ([11, 2, 8, 1, 6], 9), ([4, 4], 2), ([3, 9, 27, 4, 7], 5)]
KNOBS = dict(num_blocks=20, block_size=4, max_batch=2)
ROWS_READ = 'defer_kv_rows_read_total{server="paged"}'
ROWS_BASE = 'defer_kv_rows_gathered_baseline_total{server="paged"}'
HITS = 'defer_prefix_cache_hits_total{server="paged"}'

_models: dict = {}
_jax_runs: dict = {}


def _model(family, seq_len=64):
    """(port decoder, port params, JAX decoder, JAX params), built once."""
    key = (family, seq_len)
    if key not in _models:
        jdec = JAX[family](seq_len)
        jparams = jdec.init(jax.random.key(0))
        _models[key] = (PORT[family](seq_len, device=CPU),
                        params_from_jax(jparams, CPU), jdec, jparams)
    return _models[key]


def _requests(vocab, prompts=PROMPTS):
    return [(torch.tensor([p]) % vocab, s) for p, s in prompts]


def _port_run(family, reqs, seq_len=64, **knobs):
    dec, params, _, _ = _model(family, seq_len)
    with obs.counter_deltas() as d:
        outs, stats = serve_paged(dec, params, reqs, **knobs)
    return outs, stats, d


def _jax_run(family, reqs, seq_len=64, **knobs):
    """The JAX package's run of the same requests, memoized per knobs."""
    key = (family, seq_len, repr([(p.tolist(), s) for p, s in reqs]),
           repr(sorted(knobs.items())))
    if key not in _jax_runs:
        _, _, jdec, jparams = _model(family, seq_len)
        jreqs = [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in reqs]
        with jax_obs.counter_deltas() as d:
            outs, stats = jax_serve_paged(jdec, jparams, jreqs, **knobs)
        _jax_runs[key] = ([np.asarray(o) for o in outs], stats, d)
    return _jax_runs[key]


def _assert_same_tokens(outs, jouts, msg=""):
    assert len(outs) == len(jouts)
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)


@pytest.mark.parametrize(
    "family,attention,prefix_cache,prefill_chunk",
    list(itertools.product(["gpt", "llama"], ["gathered", "pallas"],
                           [False, True], [None, 3])),
)
def test_serve_paged_matches_jax(family, attention, prefix_cache,
                                 prefill_chunk):
    dec = _model(family)[0]
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(KNOBS, prefix_cache=prefix_cache,
                 prefill_chunk=prefill_chunk)
    outs, stats, d = _port_run(family, reqs, attention=attention, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats, jd = _jax_run(family, reqs, attention=jatt, **knobs)
    msg = f"{family} {attention} prefix_cache={prefix_cache} chunk={prefill_chunk}"
    _assert_same_tokens(outs, jouts, msg)
    for key in ("ticks", "peak_blocks", "prefill_tokens_saved",
                "cached_blocks", "prefill_chunk", "prefill_stall_ticks",
                "host_dispatches", "tokens_per_dispatch", "pool_blocks",
                "flat_equivalent_rows"):
        assert stats[key] == jstats[key], (key, msg)
    assert d.get(HITS, 0) == jd.get(HITS, 0)
    assert d[ROWS_BASE] == jd[ROWS_BASE]
    if attention == "pallas":
        # Per-slot live spans: never more than blockwise's batch max.
        assert 0 < d[ROWS_READ] <= jd[ROWS_READ] < d[ROWS_BASE]
    else:
        assert d[ROWS_READ] == jd[ROWS_READ]
    assert stats["pool_bytes"] == jstats["pool_bytes"]
    if prefix_cache:
        assert stats["prefill_tokens_saved"] > 0 and d[HITS] > 0


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_blockwise_matches_jax(prefill_chunk):
    """The port's plain "blockwise" mode against JAX's: the same tokens,
    and the same rows read (every slot to the batch's deepest live
    block, a chunk to its own)."""
    dec = _model("llama")[0]
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(KNOBS, attention="blockwise", prefix_cache=True,
                 prefill_chunk=prefill_chunk)
    outs, stats, d = _port_run("llama", reqs, **knobs)
    jouts, jstats, jd = _jax_run("llama", reqs, **knobs)
    _assert_same_tokens(outs, jouts)
    assert stats["ticks"] == jstats["ticks"]
    for key in (ROWS_READ, ROWS_BASE, HITS):
        assert d[key] == jd[key], key


def test_pallas_matches_the_jax_kernel_server():
    """The JAX package's own "pallas" server (its kernels in interpret
    mode) against the port's: the same tokens and the same per-slot
    row counters."""
    dec = _model("llama")[0]
    reqs = _requests(dec.cfg.vocab_size)[:3]
    knobs = dict(KNOBS, attention="pallas", prefix_cache=True,
                 prefill_chunk=3)
    outs, stats, d = _port_run("llama", reqs, **knobs)
    jouts, jstats, jd = _jax_run("llama", reqs, **knobs)
    _assert_same_tokens(outs, jouts)
    assert stats["ticks"] == jstats["ticks"]
    for key in (ROWS_READ, ROWS_BASE, HITS):
        assert d[key] == jd[key], key


@pytest.mark.parametrize("attention", ["gathered", "pallas"])
def test_pool_small_enough_that_requests_wait(attention):
    """Five requests through 4 slots and a 6-block pool: admission waits
    for finishers, and the outputs are still JAX's and solo generate's."""
    dec, params, _, _ = _model("gpt")
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(num_blocks=7, block_size=4, max_batch=4)
    outs, stats, _ = _port_run("gpt", reqs, attention=attention, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats, _ = _jax_run("gpt", reqs, attention=jatt, **knobs)
    _assert_same_tokens(outs, jouts)
    assert stats["peak_blocks"] == jstats["peak_blocks"] <= 6
    assert stats["ticks"] == jstats["ticks"]
    for (prompt, steps), got in zip(reqs, outs):
        torch.testing.assert_close(got, dec.generate(params, prompt, steps),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_max_len_not_a_block_multiple(prefill_chunk):
    """max_len 30 at block_size 4: the gathered view holds MB * bs = 32
    rows, more than max_len. The decoder's step must take S from the
    cache it is given (a radix admission prefills on a gathered 32-row
    lane; a gathered chunk attends a 32-row view), as the JAX package's
    `_block` does."""
    dec = _model("llama", 30)[0]
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(KNOBS, attention="gathered", prefix_cache=True,
                 prefill_chunk=prefill_chunk)
    outs, stats, d = _port_run("llama", reqs, 30, **knobs)
    jouts, jstats, jd = _jax_run("llama", reqs, 30, **knobs)
    _assert_same_tokens(outs, jouts)
    assert d[HITS] == jd[HITS] > 0
    assert stats["peak_blocks"] == jstats["peak_blocks"]


def test_learned_positions_tail_pad_past_max_len():
    """A padded tail chunk may reach past max_len when block_size does
    not divide it (max_len 30, a 5-token tail padded to 8 rows, 24..31):
    the pad rows are dropped, and the real ones equal solo decoding."""
    dec, params, _, _ = _model("gpt", 30)
    prompt = torch.tensor([[(7 * i) % 128 for i in range(29)]])
    outs, _, _ = _port_run("gpt", [(prompt, 1)], 30, num_blocks=10,
                           block_size=4, max_batch=1, attention="pallas",
                           prefill_chunk=8)
    torch.testing.assert_close(outs[0], dec.generate(params, prompt, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_shared_prefix_ids_matches_jax(prefill_chunk):
    dec = _model("llama")[0]
    reqs = _requests(dec.cfg.vocab_size)[:4]
    prefix = [7, 3, 1, 12, 9, 2, 5, 8]
    knobs = dict(KNOBS, attention="blockwise", prefill_chunk=prefill_chunk)
    outs, stats, _ = _port_run("llama", reqs,
                               prefix_ids=torch.tensor([prefix]), **knobs)
    jouts, jstats, _ = _jax_run(
        "llama", reqs, prefix_ids=jnp.asarray([prefix], jnp.int32), **knobs
    )
    _assert_same_tokens(outs, jouts)
    assert stats["shared_prefix_blocks"] == jstats["shared_prefix_blocks"] == 2
    assert stats["peak_blocks"] == jstats["peak_blocks"]


def test_prefix_block_cache_matches_jax():
    """The same walk / register / release / evict sequence through both
    classes: the same digests, hits, refcounts, LRU order, evictions
    and generation."""
    bs = 4
    chains = [np.array([3, 9, 27, 4, 1, 8, 2, 6, 5, 0, 1, 2]),
              np.array([3, 9, 27, 4, 1, 8, 2, 6, 7, 7, 7, 7]),
              np.array([5, 5, 5, 5, 3, 9, 27, 4])]
    caches = (PrefixBlockCache(), JaxPrefixBlockCache())
    next_blk = [1, 1]
    owned: list[list] = [[], []]
    for c, cache in enumerate(caches):
        for tokens in chains:
            n_full = len(tokens) // bs
            hits, keys, toks = cache.walk(tokens, n_full, bs)
            blocks = list(hits)
            for j in range(len(hits), n_full):
                blk = next_blk[c]
                next_blk[c] += 1
                assert cache.register(keys[j], toks[j], blk) is None
                blocks.append(blk)
            owned[c].append((hits, keys, blocks))
        for _, _, blocks in owned[c][:2]:
            for blk in reversed(blocks):
                cache.release(blk)
        owned[c].append(cache.evict(2))
    assert owned[0] == owned[1]
    port, ref = caches
    assert port.ref == ref.ref and list(port.lru) == list(ref.lru)
    assert port.by_key == ref.by_key and port.tok_of == ref.tok_of
    assert port.resident_digests() == ref.resident_digests()
    assert port.cached_blocks == ref.cached_blocks
    # A revived walk hits the parked blocks of the first chain again.
    assert port.walk(chains[0], 3, bs)[0] == ref.walk(chains[0], 3, bs)[0]


def test_eos_stop_and_streaming():
    dec, params, _, _ = _model("gpt")
    reqs = _requests(dec.cfg.vocab_size)
    free = dec.generate(params, reqs[0][0], reqs[0][1])
    eos = int(free[0, reqs[0][0].shape[1] + 1])
    knobs = dict(KNOBS, attention="pallas", prefix_cache=True)
    outs, stats, _ = _port_run("gpt", reqs, eos_id=eos, **knobs)
    jouts, jstats, _ = _jax_run("gpt", reqs, eos_id=eos,
                                **dict(knobs, attention="blockwise"))
    _assert_same_tokens(outs, jouts)
    assert outs[0].shape[1] < free.shape[1] and outs[0][0, -1] == eos

    prompt = reqs[2][0]
    full = dec.generate(params, prompt, 9)[0]
    gen = full[prompt.shape[1]:]
    stop = [int(gen[3]), int(gen[4])]
    streamed: dict = {}
    finals = []

    def on_token(rid, tok, done):
        streamed.setdefault(rid, []).append(tok)
        if done:
            finals.append(rid)

    srv = PagedDecodeServer(dec, params, on_token=on_token,
                            attention="pallas", prefill_chunk=3, **KNOBS)
    r_stop = srv.submit(prompt, 9, stop=[stop])
    r_free = srv.submit(prompt, 9)
    done = srv.run()
    first_end = next(j for j in range(1, len(gen))
                     if gen[j - 1:j + 1].tolist() == stop)
    got = done[r_stop][0]
    assert len(got) == prompt.shape[1] + first_end + 1 < len(full)
    torch.testing.assert_close(got, full[: len(got)], rtol=0, atol=0)
    torch.testing.assert_close(done[r_free][0], full, rtol=0, atol=0)
    assert sorted(finals) == [r_stop, r_free]
    for rid in (r_stop, r_free):
        assert streamed[rid] == done[rid][0, prompt.shape[1]:].tolist()
    assert srv.blocks_in_use == 0 and sorted(srv.free) == list(range(1, 20))


def test_sampled_slot_reproduces_solo_generate():
    dec, params, _, _ = _model("llama")
    reqs = _requests(dec.cfg.vocab_size)[:3]
    samps = [SamplingParams(temperature=0.9, top_k=20, seed=7), None,
             SamplingParams(temperature=1.2, top_p=0.9, seed=3)]
    outs, _, _ = _port_run("llama", reqs, sampling=samps,
                           attention="pallas", prefix_cache=True,
                           prefill_chunk=3, **KNOBS)
    for (prompt, steps), sp, got in zip(reqs, samps, outs):
        want = dec.generate(params, prompt, steps) if sp is None else (
            dec.generate(params, prompt, steps, temperature=sp.temperature,
                         top_k=sp.top_k, top_p=sp.top_p,
                         generator=torch.Generator().manual_seed(sp.seed))
        )
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_step_is_one_round_of_run():
    """Driving the server by `step()` serves what `run()` serves: the
    first round admits and ticks, each later one ticks once, and a
    drained server's step does nothing."""
    dec, params, _, _ = _model("llama")
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(KNOBS, attention="pallas", prefix_cache=True,
                 prefill_chunk=3)
    want, stats, _ = _port_run("llama", reqs, **knobs)
    srv = PagedDecodeServer(dec, params, **knobs)
    rids = [srv.submit(p, s) for p, s in reqs]
    rounds = 0
    while srv.step():
        rounds += 1
    assert rounds == srv.ticks == stats["ticks"]
    assert not srv.step() and srv.ticks == rounds
    _assert_same_tokens([srv.done[r] for r in rids],
                        [w.numpy() for w in want])


def test_device_tables_and_positions_follow_the_host():
    """Each tick reads the device tables and positions; they must equal
    the host mirrors (idle slots at 0 with an all-trash table), and a
    live slot never writes trash block 0."""
    dec, params, _, _ = _model("llama")
    srv = PagedDecodeServer(dec, params, attention="pallas",
                            prefix_cache=True, **KNOBS)
    for p, s in _requests(dec.cfg.vocab_size):
        srv.submit(p, s)
    seen = []
    orig = srv._step

    def spy(nb_live):
        live = np.array([s is not None for s in srv.slots])
        np.testing.assert_array_equal(srv._tables_dev.numpy(),
                                      np.where(live[:, None], srv.tables, 0))
        np.testing.assert_array_equal(srv._pos_dev.numpy(),
                                      np.where(live, srv.pos, 0))
        rows = srv.tables[np.arange(srv.B), srv.pos // srv.bs]
        assert (rows[live] != 0).all()
        assert 0 not in srv.free
        seen.append(nb_live)
        return orig(nb_live)

    srv._step = spy
    srv.run()
    assert seen and srv._tables_dev.abs().sum() == 0
    assert srv._pos_dev.abs().sum() == 0


def test_knobs_not_ported_raise():
    """Every knob is ported now (mesh= and pp_stages, pp x tp and a data
    axis beside the model axis are held over ranks in
    tests/test_torch_paged_{tp,pp,mesh}.py): in one process a
    {"stage": 2, "model": 1} mesh builds a pp x tp server on its stage
    submeshes, and a data axis of 2 needs one process a mesh position;
    the rest check the JAX package's validation errors: device= pins the
    server where it is asked to, and the fleet seams refuse a server
    without the radix cache."""
    dec, params, _, _ = _model("gpt", 32)
    base = dict(num_blocks=8, block_size=4)
    two = [CPU] * 2
    pptp = PagedDecodeServer(dec, params, **base, pp_stages=2,
                             mesh=make_mesh({"stage": 2, "model": 1}, two))
    assert pptp.pp == 2 and pptp.mesh_label == "model=1"
    half = dec.cfg.num_layers // 2
    assert [len(s.params["stack"]["wq"]) for s in pptp._pp_stage_objs] \
        == [half, half]
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        PagedDecodeServer(dec, params, **base,
                          mesh=make_mesh({"data": 2, "model": 1}, two))
    assert PagedDecodeServer(dec, params, **base, device=CPU).device == CPU
    for kw, match in (
        (dict(decode_window=0), "decode_window"),
        (dict(spec_k=1), "spec_draft"),
        (dict(spec_k=1, spec_draft=dec, spec_params=params,
              prefix_ids=torch.zeros((1, 4), dtype=torch.long)),
         "prefix_ids"),
        (dict(spec_k=1, spec_draft=dec, spec_params=params,
              prefill_budget=4), "prefill_budget"),
        (dict(prefill_budget=0), "prefill_budget"),
        (dict(constraints={}, eos_id=None), "eos_id"),
    ):
        with pytest.raises(ValueError, match=match):
            PagedDecodeServer(dec, params, **base, **kw)
    banked = {**params, "stack": {**params["stack"],
                                  "wq:a": torch.zeros(4, 1, 64, 2)}}
    with pytest.raises(ValueError, match="LoRA"):
        PagedDecodeServer(dec, banked, prefix_cache=True, **base)
    srv = PagedDecodeServer(dec, params, **base)
    with pytest.raises(ValueError, match="adapter banks"):
        srv.submit(torch.tensor([[1]]), 2, adapter_id=1)
    with pytest.raises(ValueError, match="without constraints"):
        srv.submit(torch.tensor([[1]]), 2,
                   sampling=SamplingParams(constraint="json"))
    with pytest.raises(KeyError, match="no pending prefilled"):
        srv.deliver_kv(7, torch.zeros(1), torch.zeros(1), torch.zeros(1))
    # The fleet seams, ported since, refuse a server without the radix
    # cache as the JAX package's do (tests/test_torch_fleet.py has them).
    with pytest.raises(ValueError, match="prefix_cache"):
        srv.export_prefix_blocks([])
    with pytest.raises(ValueError, match="prefix_cache"):
        srv.import_prefix_blocks([], torch.zeros(1), torch.zeros(1))


def test_validation():
    dec, params, _, _ = _model("gpt", 32)
    with pytest.raises(ValueError, match="num_blocks"):
        PagedDecodeServer(dec, params, num_blocks=1)
    with pytest.raises(ValueError, match="attention"):
        PagedDecodeServer(dec, params, num_blocks=8, attention="flash")
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedDecodeServer(dec, params, num_blocks=8, kv_dtype="fp8")
    with pytest.raises(ValueError, match="decode_window"):
        PagedDecodeServer(dec, params, num_blocks=8, decode_window=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedDecodeServer(dec, params, num_blocks=8, prefill_chunk=0)
    with pytest.raises(ValueError, match="spill_bytes"):
        PagedDecodeServer(dec, params, num_blocks=8, spill_bytes=8)
    with pytest.raises(ValueError, match="pp_inflight"):
        PagedDecodeServer(dec, params, num_blocks=8, pp_inflight=2)
    with pytest.raises(ValueError, match="block_size"):
        PagedDecodeServer(dec, params, num_blocks=8, block_size=4,
                          prefix_ids=torch.zeros((1, 6), dtype=torch.long))
    with pytest.raises(ValueError, match="subsumes"):
        PagedDecodeServer(dec, params, num_blocks=8, prefix_cache=True,
                          prefix_ids=torch.zeros((1, 4), dtype=torch.long))
    srv = PagedDecodeServer(dec, params, num_blocks=4, block_size=4)
    with pytest.raises(ValueError, match="one request"):
        srv.submit(torch.zeros((2, 3), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(torch.zeros((1, 3), dtype=torch.long), 40)
    with pytest.raises(ValueError, match="usable"):
        srv.submit(torch.zeros((1, 3), dtype=torch.long), 12)
