"""The port's stall-free mixed ticks (PagedDecodeServer(prefill_budget=N),
runtime/schedule.py) against the JAX package's.

`PrefillSeat` and `plan_mixed_tick` are the port's own copies: over a
grid of seats, budgets, chunk caps and T limits they must plan exactly
what the JAX package's plan. Served on the same weights (the JAX
package's init, carried over with `params_from_jax`) in float32 on the
CPU, `serve_paged(prefill_budget=N)` must give the JAX package's tokens
with the same knobs, and the tokens of `prefill_budget=None`, with a
radix hit and a prompt longer than the budget in the mix; the mixed
tick, stall and dispatch counters must equal the JAX package's. A decode
slot must advance one token on every tick a later prompt spends
prefilling beside it.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.runtime import schedule as jschedule
from defer_tpu.runtime.paged import serve_paged as jax_serve_paged
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.runtime import schedule
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged

CPU = torch.device("cpu")
KNOBS = dict(num_blocks=32, block_size=4, max_batch=2)
STATS = ("ticks", "host_dispatches", "tokens_per_dispatch", "mixed_ticks",
         "mixed_prefill_tokens", "prefill_stall_ticks",
         "decode_stall_fraction", "peak_blocks", "prefill_tokens_saved",
         "prefill_budget")

_jax_runs: dict = {}


@pytest.fixture(scope="module")
def model():
    jdec = jax_tiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    return (tiny_gpt(64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


def _requests():
    """The JAX package's mix (tests/test_mixed.py): two prompts sharing
    a 6-token prefix and an 11-token prompt longer than every budget
    below; then a fourth behind the same prefix, admitted once the first
    has flipped and published its blocks (a radix hit under
    prefix_cache)."""
    rng = np.random.default_rng(3)
    base = rng.integers(1, 128, size=(1, 6))
    ext = rng.integers(1, 128, size=(1, 4))
    return [(base, 7), (np.concatenate([base, ext], axis=1), 5),
            (rng.integers(1, 128, size=(1, 11)), 6),
            (np.concatenate([base, ext[:, :2]], axis=1), 3)]


def _port(model, **knobs):
    dec, params, _, _ = model
    reqs = [(torch.tensor(p), s) for p, s in _requests()]
    return serve_paged(dec, params, reqs, **knobs)


def _jax(model, **knobs):
    key = repr(sorted(knobs.items()))
    if key not in _jax_runs:
        _, _, jdec, jparams = model
        reqs = [(jnp.asarray(p, jnp.int32), s) for p, s in _requests()]
        outs, stats = jax_serve_paged(jdec, jparams, reqs, **knobs)
        _jax_runs[key] = ([np.asarray(o) for o in outs], stats)
    return _jax_runs[key]


def _same(outs, want, msg=""):
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=msg)


# -- the host-side planner ----------------------------------------------------

@pytest.mark.parametrize(
    "remaining,budget,chunk_cap,t_limit",
    list(itertools.product([[], [10], [10, 10], [1, 7, 3], [0, 5]],
                           [1, 4, 6, 8], [1, 3, 8], [1, 5, 8])),
)
def test_plan_matches_jax(remaining, budget, chunk_cap, t_limit):
    got = schedule.plan_mixed_tick(remaining, budget, chunk_cap, t_limit)
    want = jschedule.plan_mixed_tick(remaining, budget, chunk_cap, t_limit)
    assert got == want


def test_plan_and_seat_errors_match_jax():
    for args in (([5], 0, 4, 4), ([5], 4, 0, 4), ([5], 4, 4, 0),
                 ([-1], 4, 4, 4)):
        with pytest.raises(ValueError) as got:
            schedule.plan_mixed_tick(*args)
        with pytest.raises(ValueError) as want:
            jschedule.plan_mixed_tick(*args)
        assert str(got.value) == str(want.value)
    for mod in (schedule, jschedule):
        with pytest.raises(ValueError, match="at least one token"):
            mod.PrefillSeat(rid=1, tokens=np.zeros((0,)), base=0,
                            keep_from=0)


def test_seat_progress_matches_jax():
    seats = [mod.PrefillSeat(rid=1, tokens=np.arange(7), base=8,
                             keep_from=4) for mod in (schedule, jschedule)]
    for n in (3, 1, 3):
        chunks = [s.take(n) for s in seats]
        np.testing.assert_array_equal(*chunks)
        assert [(s.remaining, s.pos, s.finished) for s in seats][0] == (
            seats[1].remaining, seats[1].pos, seats[1].finished)
    assert all(s.finished for s in seats)
    assert [schedule.pow2_bucket(n, 16) for n in (0, 1, 3, 9, 17)] == [
        jschedule.pow2_bucket(n, 16) for n in (0, 1, 3, 9, 17)]


# -- serving --------------------------------------------------------------------

@pytest.mark.parametrize(
    "attention,prefix_cache,window,budget",
    [("gathered", False, 1, 4), ("gathered", True, 1, 4),
     ("gathered", True, 4, 2), ("pallas", False, 1, 4),
     ("pallas", True, 4, 4), ("blockwise", True, 1, 3)],
)
def test_mixed_matches_jax_and_the_stall_path(model, attention,
                                              prefix_cache, window, budget):
    knobs = dict(KNOBS, prefix_cache=prefix_cache, decode_window=window)
    mixed, stats = _port(model, attention=attention, prefill_budget=budget,
                         **knobs)
    stall, _ = _port(model, attention=attention, **knobs)
    jatt = "blockwise" if attention == "pallas" else attention
    jmixed, jstats = _jax(model, attention=jatt, prefill_budget=budget,
                          **knobs)
    msg = f"{attention} prefix_cache={prefix_cache} K={window} N={budget}"
    _same(mixed, jmixed, msg)
    _same(mixed, stall, msg)
    for key in STATS:
        assert stats[key] == jstats[key], (key, msg)
    assert stats["mixed_ticks"] > 0
    assert stats["prefill_stall_ticks"] == 0
    if prefix_cache:
        assert stats["prefill_tokens_saved"] > 0


def test_stall_counters_match_jax(model):
    """The stall path, which the budget removes, counts its stalls as
    the JAX package does."""
    knobs = dict(KNOBS, attention="gathered", prefill_chunk=3)
    _, stats = _port(model, **knobs)
    _, jstats = _jax(model, **knobs)
    assert stats["prefill_stall_ticks"] == jstats["prefill_stall_ticks"] > 0
    assert stats["decode_stall_fraction"] == pytest.approx(
        jstats["decode_stall_fraction"], rel=0, abs=0)
    assert stats["ticks"] == jstats["ticks"]


def test_sampled_eos_and_stop_under_a_budget(model):
    """Sampled, eos and stop requests: the mixed path draws from each
    slot's generator exactly as the stall path does."""
    dec, params, _, _ = model
    reqs = [(torch.tensor(p), s) for p, s in _requests()]
    free = dec.generate(params, reqs[2][0], 6)[0, reqs[2][0].shape[1]:]
    runs = []
    for budget in (None, 3):
        srv = PagedDecodeServer(dec, params, eos_id=int(free[3]),
                                prefill_budget=budget, attention="pallas",
                                **KNOBS)
        rids = [srv.submit(reqs[0][0], 7, sampling=SamplingParams(
                    temperature=0.8, top_k=10, seed=5)),
                srv.submit(reqs[1][0], 5, stop=[[int(free[0])]]),
                srv.submit(reqs[2][0], 6)]
        done = srv.run()
        runs.append([done[r] for r in rids])
    _same(runs[1], runs[0])
    assert runs[0][2].shape[1] == reqs[2][0].shape[1] + 4


def test_decode_never_skips_a_tick_while_a_prompt_prefills(model):
    dec, params, _, _ = model
    rng = np.random.default_rng(5)
    srv = PagedDecodeServer(dec, params, num_blocks=48, block_size=4,
                            max_batch=2, prefill_budget=2,
                            attention="pallas")
    srv.submit(torch.tensor(rng.integers(1, 64, size=(1, 4))), 32)
    srv._admit()
    while srv._seat_slots():
        srv._tick()
    (i0,) = [i for i, s in enumerate(srv.slots) if s is not None]
    long = torch.tensor(rng.integers(1, 64, size=(1, 17)))
    srv.submit(long, 4)
    srv._admit()
    assert srv._seat_slots()
    ticks = 0
    while srv._seat_slots():
        before = len(srv.slots[i0]["toks"])
        srv._tick()
        assert len(srv.slots[i0]["toks"]) == before + 1
        ticks += 1
    assert ticks >= 3
    assert srv.prefill_stall_ticks_n == 0
    assert srv.mixed_prefill_tokens_n >= long.shape[1]
    srv.run()
    assert srv._submit_t == {} and srv.blocks_in_use == 0


def test_budget_validation(model):
    dec, params, _, _ = model
    with pytest.raises(ValueError, match="prefill_budget must be >= 1"):
        PagedDecodeServer(dec, params, num_blocks=8, prefill_budget=0)
    with pytest.raises(ValueError, match="prefill_lookahead"):
        PagedDecodeServer(dec, params, num_blocks=8, prefill_budget=2,
                          prefill_lookahead=0)
    with pytest.raises(ValueError, match="prefill_budget=None server"):
        PagedDecodeServer(dec, params, num_blocks=8, prefill_budget=2,
                          spec_k=1, spec_draft=dec, spec_params=params)
