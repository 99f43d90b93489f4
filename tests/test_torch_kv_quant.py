"""The port's int8 KV pool (`kv_dtype="int8"`) and host spill tier
(`spill_bytes=`) against the JAX package's.

The same numpy-seeded pools, rows and requests, and the JAX package's
random weights carried over with `params_from_jax`, go through
`defer_tpu` and the port in float32 on the CPU, at tiny sizes
(`tiny_gpt`/`tiny_llama`, block_size 4). What is held, and how closely:

  * the int8 row writes: `_pool_write_rows` and the multi-token write
    against the JAX package's on the same pool, int8 codes equal and
    scales within 1 ulp (both quantize in f32 with the same formula; XLA
    may contract the arithmetic differently); the port's row-round form
    of the multi-token write against the token-by-token loop, bit for
    bit;
  * `serve_paged(kv_dtype="int8")`: tokens identical to the JAX
    package's and the pool accounting equal (ticks, peak blocks, prefill
    tokens saved, pool bytes, the `defer_kv_rows_*` counters) across
    attention x prefix_cache x prefill_chunk; the port's "pallas" mode
    runs its kernels' plain versions here, the JAX package's int8
    `_blockwise_attend(_mt)` fold, so it is held against JAX "blockwise",
    and one case against JAX's own "pallas" server (interpret mode);
  * teacher-forced logits along the JAX fp greedy trajectory: the port's
    int8 logits within 1e-3 of the logit scale of JAX's int8 ones (the
    same quantized pool, f32 summation order apart), and within 5% of
    the scale of the port's fp logits, and not equal to them (the JAX
    package's accuracy contract);
  * `defer_kv_rows_read_total` counts rows, the same for fp and int8;
  * spill revival is token-identical to a resident radix hit, for fp and
    int8 pools, and matches the JAX package's spill run in spill hits,
    stored blocks and prefill tokens saved; the spill counters and stats
    surface, and spill_bytes without prefix_cache raises.
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
from defer_tpu.runtime.paged import PagedDecodeServer as JaxPagedDecodeServer
from defer_tpu.runtime.paged import _pool_write_rows as jax_write_rows
from defer_tpu.runtime.paged import _pool_write_rows_mt as jax_write_rows_mt
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import obs, params_from_jax
from defer_tpu_torch.models.gpt import tiny_gpt
from defer_tpu_torch.models.llama import tiny_llama
from defer_tpu_torch.models.quant import quantize_symmetric
from defer_tpu_torch.runtime.paged import (
    PagedDecodeServer,
    _pool_write_rows,
    _pool_write_rows_mt,
    serve_paged,
)

CPU = torch.device("cpu")
JAX = {"gpt": jax_tiny_gpt, "llama": jax_tiny_llama}
PORT = {"gpt": tiny_gpt, "llama": tiny_llama}
# Requests 0, 1 and 4 share their first full blocks at block_size 4.
PROMPTS = [([3, 9, 27, 4, 1, 8, 2, 6, 5], 7),
           ([3, 9, 27, 4, 1, 8, 2, 6, 11, 2], 4),
           ([11, 2, 8, 1, 6], 9), ([4, 4], 2), ([3, 9, 27, 4, 7], 5)]
KNOBS = dict(num_blocks=20, block_size=4, max_batch=2, kv_dtype="int8")
ROWS_READ = 'defer_kv_rows_read_total{server="paged"}'
ROWS_BASE = 'defer_kv_rows_gathered_baseline_total{server="paged"}'
HITS = 'defer_prefix_cache_hits_total{server="paged"}'
SPILLED = 'defer_prefix_spilled_total{server="paged"}'
SPILL_HITS = 'defer_prefix_spill_hits_total{server="paged"}'

_models: dict = {}


def _model(family="gpt"):
    """(port decoder, port params, JAX decoder, JAX params), built once."""
    if family not in _models:
        jdec = JAX[family](64)
        jparams = jdec.init(jax.random.key(0))
        _models[family] = (PORT[family](64, device=CPU),
                           params_from_jax(jparams, CPU), jdec, jparams)
    return _models[family]


def _requests(vocab):
    return [(torch.tensor([p]) % vocab, s) for p, s in PROMPTS]


def _jax_requests(reqs):
    return [(jnp.asarray(p.numpy(), jnp.int32), s) for p, s in reqs]


# -- the int8 row writes ---------------------------------------------------


def _int8_pool(seed, nb=8, hkv=2, bs=4, dh=8):
    """A seeded int8 pool layer as both packages hold it: (port pair,
    JAX pair)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((nb, hkv, bs, dh), np.float32))
    q, s = quantize_symmetric(x, axis=(-2, -1))
    port = {"q": q.clone(), "s": s.clone()}
    ref = {"q": jnp.asarray(q.numpy()), "s": jnp.asarray(s.numpy())}
    return rng, port, ref


def _assert_pool_matches(port, ref, blocks):
    """int8 codes equal and scales within 1 ulp on the pool blocks
    `blocks` (trash block 0 is raced over)."""
    q, s = np.asarray(ref["q"])[blocks], np.asarray(ref["s"])[blocks]
    np.testing.assert_array_equal(port["q"].numpy()[blocks], q)
    np.testing.assert_array_max_ulp(port["s"].numpy()[blocks], s, maxulp=1)


def test_pool_write_rows_matches_jax():
    """One row per entry into an int8 pool: two live blocks (one at its
    last row, one at row 0, whose later rows hold garbage that must be
    zeroed before the scale is taken) and two idle entries on trash."""
    rng, port, ref = _int8_pool(0)
    dest, rowi = [3, 5, 0, 0], [3, 0, 0, 0]
    val = rng.standard_normal((4, 2, 8), np.float32) * 3.0
    _pool_write_rows(port, torch.tensor(dest), torch.tensor(rowi),
                     torch.from_numpy(val))
    ref = jax_write_rows(ref, jnp.asarray(dest), jnp.asarray(rowi),
                         jnp.asarray(val))
    _assert_pool_matches(port, ref, slice(1, None))
    # Row 0 landed alone: the block's other rows dequantize to zeros.
    assert not port["q"][5, :, 1:].any()


@pytest.mark.parametrize("t,pos", [(3, [1, 6]), (9, [5, 2]), (16, [0, 7])])
def test_multi_token_write_matches_jax(t, pos):
    """T rows a slot at consecutive positions through the slots' tables,
    pad rows past n_keep redirected to trash block 0 (as `_mt` does):
    the JAX package's column loop and the port's write (the same loop
    at T <= bs, row rounds past it) leave the same pool."""
    rng, port, ref = _int8_pool(1, nb=14)
    bs = 4
    tables = np.array([[2, 4, 6, 8, 10, 12], [3, 5, 7, 9, 11, 13]])
    n_keep = np.array([t, t - 2])
    pvec = np.asarray(pos)[:, None] + np.arange(t)
    blk = np.take_along_axis(tables, pvec // bs, axis=1)
    dest = np.where(np.arange(t)[None, :] < n_keep[:, None], blk, 0)
    rowi = pvec % bs
    val = rng.standard_normal((2, t, 2, 8), np.float32)
    _pool_write_rows_mt(port, torch.from_numpy(dest), torch.from_numpy(rowi),
                        torch.from_numpy(val))
    ref = jax_write_rows_mt(ref, jnp.asarray(dest), jnp.asarray(rowi),
                            jnp.asarray(val))
    _assert_pool_matches(port, ref, slice(1, None))


def test_row_rounds_are_the_column_loop_bit_for_bit():
    """The port's row-round multi-token write (T > bs) against the
    single-row write applied column by column: the same pool, bit for
    bit, trash block 0 apart."""
    rng, port, _ = _int8_pool(2, nb=16)
    loop = {k: v.clone() for k, v in port.items()}
    bs, t = 4, 11
    tables = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10],
                           [11, 12, 13, 14, 15]])
    pos = torch.tensor([2, 0, 5])
    pvec = pos[:, None] + torch.arange(t)
    dest = torch.where(torch.arange(t)[None, :] < torch.tensor([[11], [9],
                                                               [4]]),
                       tables.gather(1, pvec // bs), 0)
    rowi = pvec % bs
    val = torch.from_numpy(rng.standard_normal((3, t, 2, 8), np.float32))
    _pool_write_rows_mt(port, dest, rowi, val)
    for j in range(t):
        _pool_write_rows(loop, dest[:, j], rowi[:, j], val[:, j])
    for key in ("q", "s"):
        torch.testing.assert_close(port[key][1:], loop[key][1:], rtol=0,
                                   atol=0)


# -- the int8 server against the JAX package's -------------------------------


def _port_run(family, reqs, **knobs):
    dec, params, _, _ = _model(family)
    with obs.counter_deltas() as d:
        outs, stats = serve_paged(dec, params, reqs, **knobs)
    return outs, stats, d


def _jax_run(family, reqs, **knobs):
    _, _, jdec, jparams = _model(family)
    with jax_obs.counter_deltas() as d:
        outs, stats = jax_serve_paged(jdec, jparams, _jax_requests(reqs),
                                      **knobs)
    return [np.asarray(o) for o in outs], stats, d


def _assert_same_tokens(outs, jouts, msg=""):
    assert len(outs) == len(jouts)
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)


@pytest.mark.parametrize(
    "attention,prefix_cache,prefill_chunk",
    list(itertools.product(["gathered", "pallas"], [False, True],
                           [None, 3])),
)
def test_serve_paged_int8_matches_jax(attention, prefix_cache,
                                      prefill_chunk):
    dec = _model()[0]
    reqs = _requests(dec.cfg.vocab_size)
    knobs = dict(KNOBS, prefix_cache=prefix_cache,
                 prefill_chunk=prefill_chunk)
    outs, stats, d = _port_run("gpt", reqs, attention=attention, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jouts, jstats, jd = _jax_run("gpt", reqs, attention=jatt, **knobs)
    msg = f"{attention} prefix_cache={prefix_cache} chunk={prefill_chunk}"
    _assert_same_tokens(outs, jouts, msg)
    for key in ("ticks", "peak_blocks", "prefill_tokens_saved", "pool_bytes",
                "kv_dtype", "cached_blocks"):
        assert stats[key] == jstats[key], (key, msg)
    assert d.get(HITS, 0) == jd.get(HITS, 0)
    assert d[ROWS_BASE] == jd[ROWS_BASE]
    if attention == "pallas":
        # Per-slot live spans: never more than blockwise's batch max.
        assert 0 < d[ROWS_READ] <= jd[ROWS_READ] < d[ROWS_BASE]
    else:
        assert d[ROWS_READ] == jd[ROWS_READ]


def test_int8_pallas_matches_the_jax_kernel_server():
    """The JAX package's own int8 "pallas" server (its kernels' scale
    path in interpret mode) against the port's: the same tokens and the
    same per-slot row counters."""
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


def test_int8_pool_bytes_pinned():
    """The int8 pool is exactly fp_bytes / itemsize for the payload plus
    two f32 scale tensors, the JAX package's number."""
    dec = _model()[0]
    cfg = dec.cfg
    reqs = _requests(cfg.vocab_size)[:2]
    kw = dict(num_blocks=16, block_size=4, max_batch=2)
    _, st_fp, d_fp = _port_run("gpt", reqs, **kw)
    _, st_q8, d_q8 = _port_run("gpt", reqs, kv_dtype="int8", **kw)
    elems = cfg.num_layers * 16 * cfg.kv_heads * 4 * (cfg.dim // cfg.num_heads)
    scales = cfg.num_layers * 16 * cfg.kv_heads * 4  # f32, K and V
    assert st_fp["pool_bytes"] == 2 * elems * 4  # f32 compute dtype
    assert st_q8["pool_bytes"] == 2 * elems + 2 * scales
    _, jst, _ = _jax_run("gpt", reqs, kv_dtype="int8", **kw)
    assert st_q8["pool_bytes"] == jst["pool_bytes"]
    assert st_fp["kv_dtype"] == "fp" and st_q8["kv_dtype"] == "int8"
    gauge = 'defer_kv_pool_bytes{server="paged"}'
    assert st_q8["metrics"]["gauges"][gauge] == st_q8["pool_bytes"]


@pytest.mark.parametrize("attention", ["blockwise", "pallas"])
def test_kv_rows_counter_is_dtype_agnostic(attention):
    """`defer_kv_rows_read_total` means rows: an int8 pool reads the same
    row count as an fp one."""
    dec = _model()[0]
    reqs = _requests(dec.cfg.vocab_size)
    kw = dict(num_blocks=20, block_size=4, max_batch=2, attention=attention)
    _, _, d_fp = _port_run("gpt", reqs, **kw)
    _, _, d_q8 = _port_run("gpt", reqs, kv_dtype="int8", **kw)
    assert d_fp[ROWS_READ] == d_q8[ROWS_READ] > 0


# -- accuracy: teacher-forced logits -----------------------------------------


def _port_trace(prompt, steps, forced, **kw):
    """Drive one request tick by tick through the port's server, feeding
    the `forced` trajectory and recording each tick's logits row."""
    dec, params, _, _ = _model()
    srv = PagedDecodeServer(dec, params, num_blocks=16, block_size=4,
                            max_batch=1, **kw)
    srv.submit(prompt, steps)
    srv._admit()
    orig = srv._step
    rec = []

    def spy(nb_live):
        logits = orig(nb_live)
        rec.append(logits[:, -1, :].numpy().copy())
        return logits

    srv._step = spy
    t = 0
    while any(s is not None for s in srv.slots):
        srv._tick()
        if t + 1 < len(forced):
            srv._feed = torch.tensor([[forced[t + 1]]], dtype=torch.int32)
        t += 1
    return rec


def _jax_trace(prompt, steps, forced=None, **kw):
    """The JAX package's counterpart (tests/test_kv_quant.py's tick loop):
    returns (the tokens fed, each tick's logits row)."""
    _, _, jdec, jparams = _model()
    srv = JaxPagedDecodeServer(jdec, jparams, num_blocks=16, block_size=4,
                               max_batch=1, **kw)
    srv.submit(jnp.asarray(prompt.numpy(), jnp.int32), steps)
    srv._admit()
    srv._build()
    orig = srv._step
    rec = []

    def spy(*args):
        logits, pk, pv = orig(*args)
        rec.append(np.asarray(logits[:, -1, :]))
        return logits, pk, pv

    srv._step = spy
    toks = [int(np.asarray(srv._feed)[0, 0])]
    t = 0
    while any(s is not None for s in srv.slots):
        srv._tick()
        toks.append(int(np.asarray(srv._feed)[0, 0]))
        if forced is not None and t + 1 < len(forced):
            srv._feed = jnp.asarray([[forced[t + 1]]], jnp.int32)
        t += 1
    return toks, rec


@pytest.mark.parametrize("attention,prefix_cache", [
    ("gathered", False), ("gathered", True), ("pallas", False),
    ("pallas", True),
])
def test_int8_logits_track_jax_and_stay_near_fp(attention, prefix_cache):
    dec = _model()[0]
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(
        rng.integers(1, dec.cfg.vocab_size, size=(1, 11))
    )
    kw = dict(attention=attention, prefix_cache=prefix_cache)
    jkw = dict(kw, attention="blockwise" if attention == "pallas"
               else attention)
    forced, jfp = _jax_trace(prompt, 8, **jkw)
    _, jq8 = _jax_trace(prompt, 8, forced=forced, kv_dtype="int8", **jkw)
    pfp = _port_trace(prompt, 8, forced, **kw)
    pq8 = _port_trace(prompt, 8, forced, kv_dtype="int8", **kw)
    assert len(pq8) == len(jq8) == len(pfp) == len(jfp) > 0
    scale = max(float(np.abs(a).max()) for a in jfp)
    vs_jax = max(float(np.abs(a - b).max()) for a, b in zip(pq8, jq8))
    vs_fp = max(float(np.abs(a - b).max()) for a, b in zip(pq8, pfp))
    assert vs_jax <= 1e-3 * scale, (vs_jax, scale)
    assert 0 < vs_fp < 0.05 * scale, (vs_fp, scale)


# -- the host spill tier -------------------------------------------------------


def _spill_workload(vocab):
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, vocab, size=(1, 8))
    tails = [rng.integers(1, vocab, size=(1, n)) for n in (3, 2)]
    fillers = [rng.integers(1, vocab, size=(1, 9)) for _ in range(3)]
    return prefix, tails, fillers


def _run_phases(server, dec, params, ids, *, num_blocks, spill_bytes,
                kv_dtype):
    """Prefix warm-up -> pool-thrashing fillers -> the same prefix again
    (tests/test_kv_quant.py's phases, through either package: `ids`
    turns a numpy prompt into that package's tensor). With a big pool
    the second prefix request is a resident radix hit; with a small pool
    and the spill tier it comes back by revival."""
    prefix, (ta, tb), fillers = _spill_workload(dec.cfg.vocab_size)
    srv = server(dec, params, num_blocks=num_blocks, block_size=4,
                 max_batch=1, prefix_cache=True, kv_dtype=kv_dtype,
                 spill_bytes=spill_bytes)
    srv.submit(ids(np.concatenate([prefix, ta], axis=1)), 4)
    srv.run()
    for f in fillers:
        srv.submit(ids(f), 6)
        srv.run()
    if srv._spill is not None:
        srv._spill.flush()
    rid = srv.submit(ids(np.concatenate([prefix, tb], axis=1)), 5)
    return np.asarray(srv.run()[rid]), srv


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_spill_revival_token_identical_to_resident_hit(kv_dtype):
    dec, params, jdec, jparams = _model()
    port = (PagedDecodeServer, dec, params, torch.from_numpy)
    resident, srv_r = _run_phases(*port, num_blocks=64, spill_bytes=0,
                                  kv_dtype=kv_dtype)
    revived, srv_s = _run_phases(*port, num_blocks=10, spill_bytes=1 << 20,
                                 kv_dtype=kv_dtype)
    assert srv_r.spill_hits_n == 0 and srv_r._spill is None
    assert srv_s.spill_hits_n > 0 and srv_s._spill.stored_blocks > 0
    assert srv_s.prefill_tokens_saved == srv_r.prefill_tokens_saved > 0
    np.testing.assert_array_equal(revived, resident)
    # The JAX package's spill run: the same tokens, hits, stored blocks
    # and saved prefill.
    jrevived, jsrv = _run_phases(
        JaxPagedDecodeServer, jdec, jparams,
        lambda a: jnp.asarray(a, jnp.int32), num_blocks=10,
        spill_bytes=1 << 20, kv_dtype=kv_dtype,
    )
    np.testing.assert_array_equal(revived, jrevived)
    assert srv_s.spill_hits_n == jsrv.spill_hits_n
    assert srv_s._spill.stored_blocks == jsrv._spill.stored_blocks
    assert srv_s._spill.stored_bytes == jsrv._spill.stored_bytes
    assert srv_s.prefill_tokens_saved == jsrv.prefill_tokens_saved
    srv_s._spill.close()


def test_spill_counters_and_stats_surface():
    dec = _model()[0]
    prefix, (ta, tb), fillers = _spill_workload(dec.cfg.vocab_size)
    reqs = (
        [(torch.from_numpy(np.concatenate([prefix, ta], axis=1)), 4)]
        + [(torch.from_numpy(f), 6) for f in fillers]
        + [(torch.from_numpy(np.concatenate([prefix, tb], axis=1)), 5)]
    )
    _, st, d = _port_run("gpt", reqs, num_blocks=10, block_size=4,
                         max_batch=1, prefix_cache=True, kv_dtype="int8",
                         spill_bytes=1 << 20)
    assert d[SPILLED] > 0 and d[SPILL_HITS] > 0
    assert st["spill_hits"] == d[SPILL_HITS]
    assert st["spilled_blocks"] > 0 and st["spill_stored_bytes"] > 0
    gauge = 'defer_prefix_spill_bytes{server="paged"}'
    assert st["metrics"]["gauges"][gauge] == st["spill_stored_bytes"]
    _, st_off, _ = _port_run("gpt", reqs[:1], num_blocks=10, block_size=4,
                             max_batch=1)
    assert (st_off["spill_hits"], st_off["spilled_blocks"],
            st_off["spill_stored_bytes"]) == (0, 0, 0)


def test_spill_requires_prefix_cache():
    dec, params, _, _ = _model()
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedDecodeServer(dec, params, num_blocks=8, block_size=4,
                          max_batch=1, spill_bytes=1 << 20)
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedDecodeServer(dec, params, num_blocks=8, block_size=4,
                          max_batch=1, kv_dtype="int4")
