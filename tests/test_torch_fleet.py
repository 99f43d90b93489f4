"""The port's fleet serving (defer_tpu_torch/fleet/) against the JAX
package's (defer_tpu/fleet/), mirroring tests/test_fleet.py.

The same requests and weights (the JAX package's random init of
`tiny_gpt(64)`, carried over with `params_from_jax`) go through both
packages in float32 on the CPU: the port's `serve_fleet` must be
token-identical to the JAX package's `serve_fleet` and to the port's
`serve_paged` at one replica and two, with and without the radix cache
(placement may not perturb a greedy token). Around that contract, as in
the JAX file: the router's ladder and its deterministic tie-breaks (the
same decisions as the JAX router on the same board), `chain_digests`
equal to the JAX package's, SLO and full-queue shedding that never
hangs, replica death that re-routes queued work and fails in-flight
work, prefix migration that moves blocks without changing tokens (and
`export_prefix_blocks` / `import_prefix_blocks` against the JAX
server's), and the `PrefixPayload` stream, whose bytes on a loopback
socket equal the JAX wire's and which each package reads from the
other. Every thread wait has a timeout; replicas run on
`devices=[cpu]`.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.disagg import wire as jwire
from defer_tpu.fleet import AdvertisementBoard as JaxBoard
from defer_tpu.fleet import PrefixRouter as JaxRouter
from defer_tpu.fleet import chain_digests as jax_chain_digests
from defer_tpu.fleet import serve_fleet as jax_serve_fleet
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.obs import FleetMetrics as JaxFleetMetrics
from defer_tpu.runtime import transport as jtransport
from defer_tpu.runtime.paged import PagedDecodeServer as JaxPagedServer
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.disagg import wire
from defer_tpu_torch.fleet import (
    AdmissionController,
    AdvertisementBoard,
    FleetFrontend,
    PrefixRouter,
    ReplicaDeadError,
    ShedError,
    chain_digests,
    serve_fleet,
)
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.obs import FleetMetrics
from defer_tpu_torch.runtime import transport
from defer_tpu_torch.runtime.paged import PagedDecodeServer, serve_paged
from tests.test_torch_disagg import _captured

CPU = torch.device("cpu")
DEVS = [CPU]
KNOBS = dict(num_blocks=16, block_size=4, max_batch=2)
SHARED = [[3, 9, 27, 1, 4, 4, 2, 8]]

_jax_runs: dict = {}


@pytest.fixture(scope="module")
def model():
    jdec = jax_tiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    return (tiny_gpt(64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


def _prompts(vocab):
    return [
        ([[3, 9, 27, 1, 4, 4, 2, 8]], 7),
        ([[5, 1]], 4),
        ([[11, 2, 8, 1, 6]], 6),
        ([[3, 9, 27, 1, 4, 4, 2, 8]], 5),
    ]


def _requests(vocab):
    return [(torch.tensor(p) % vocab, s) for p, s in _prompts(vocab)]


def _jax_requests(vocab):
    return [(jnp.asarray(p, jnp.int32) % vocab, s)
            for p, s in _prompts(vocab)]


def _same(outs, want, msg=""):
    assert len(outs) == len(want)
    for i, (got, ref) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=f"{msg} request {i}")


def _jax_fleet(model, **knobs):
    """The JAX package's serve_fleet of the same requests, memoized."""
    key = repr(sorted(knobs.items()))
    if key not in _jax_runs:
        _, _, jdec, jparams = model
        outs, stats = jax_serve_fleet(
            jdec, jparams, _jax_requests(jdec.cfg.vocab_size), **knobs)
        _jax_runs[key] = ([np.asarray(o) for o in outs], stats)
    return _jax_runs[key]


def _fresh_obs(n: int) -> FleetMetrics:
    """FleetMetrics over the process-global registry with the load
    gauges zeroed (the reset FleetFrontend does)."""
    obs = FleetMetrics(n)
    for i in range(n):
        obs.queue_depth[i].set(0)
        obs.inflight[i].set(0)
        obs.pool_free[i].set(0)
    return obs


def _frontend(model, **kw):
    dec, params, _, _ = model
    return FleetFrontend(dec, params, devices=DEVS, **{**KNOBS, **kw})


def _hold_all(fe):
    """hold_admissions on every replica, then outwait the idle loop's
    1 ms blocking pop, so that 'held' means held."""
    for r in fe.replicas:
        r.hold_admissions = True
    time.sleep(0.05)


def _wait_until(pred, timeout=10.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


# -- token identity with serve_paged and the JAX fleet ----------------------


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_fleet_token_identical_to_serve_paged(model, n_replicas,
                                              prefix_cache):
    """Greedy outputs equal the port's serve_paged and the JAX package's
    serve_fleet with the same knobs, at one replica and at two."""
    dec, params, _, _ = model
    reqs = _requests(dec.cfg.vocab_size)
    kw = dict(KNOBS, prefix_cache=prefix_cache)
    mono, _ = serve_paged(dec, params, reqs, **kw)
    outs, stats = serve_fleet(dec, params, reqs, n_replicas=n_replicas,
                              devices=DEVS, **kw)
    msg = f"n_replicas={n_replicas} prefix_cache={prefix_cache}"
    _same(outs, mono, msg)
    jouts, jstats = _jax_fleet(model, n_replicas=n_replicas, **kw)
    _same(outs, jouts, msg + " vs JAX")
    assert stats["n_replicas"] == n_replicas
    assert sum(stats["routed"].values()) == len(reqs)
    assert sum(stats["routed"].values()) == sum(jstats["routed"].values())
    assert stats["shed"] == {"queue_full": 0, "slo": 0} == jstats["shed"]
    assert len(stats["replicas"]) == n_replicas
    assert all(r["dead"] is None for r in stats["replicas"])
    assert all(r["mesh_shape"] is None for r in stats["replicas"])


def test_fleet_sampled_request_parity(model):
    """Seeded sampling rides the routed request; streams must match the
    port's monolithic serving per request (torch and JAX generators
    differ, so the JAX fleet is not the reference here)."""
    dec, params, _, _ = model
    reqs = _requests(dec.cfg.vocab_size)
    samps = [
        SamplingParams(temperature=0.8, top_k=8, seed=11),
        None,
        SamplingParams(temperature=1.1, top_p=0.9, seed=3),
        None,
    ]
    mono, _ = serve_paged(dec, params, reqs, sampling=samps, **KNOBS)
    outs, _ = serve_fleet(dec, params, reqs, n_replicas=2, sampling=samps,
                          devices=DEVS, **KNOBS)
    _same(outs, mono, "sampled")


# -- the advertisement seam and placement -----------------------------------


def test_resident_digests_generation_and_keys(model):
    """`resident_digests` snapshots exactly the radix key set, equal to
    the JAX server's after the same request, and the generation moves
    only when the key set changes."""
    dec, params, jdec, jparams = model
    srv = PagedDecodeServer(dec, params, prefix_cache=True, **KNOBS)
    jsrv = JaxPagedServer(jdec, jparams, prefix_cache=True, **KNOBS)
    gen0, d0 = srv.resident_digests()
    assert d0 == frozenset()
    rid = srv.submit(torch.tensor(SHARED), 3)
    jrid = jsrv.submit(jnp.asarray(SHARED, jnp.int32), 3)
    while rid not in srv.done:
        srv._admit()
        srv._tick()
    while jrid not in jsrv.done:
        jsrv._admit()
        jsrv._tick()
    gen1, d1 = srv.resident_digests()
    assert gen1 > gen0
    assert d1 == jsrv.resident_digests()[1]
    assert set(chain_digests(torch.tensor(SHARED), 2, 4)) <= d1
    assert srv.radix.evict(1)
    gen2, d2 = srv.resident_digests()
    assert gen2 > gen1 and len(d2) == len(d1) - 1


def test_resident_digests_without_radix(model):
    dec, params, _, _ = model
    srv = PagedDecodeServer(dec, params, num_blocks=8, block_size=4,
                            max_batch=1)
    assert srv.resident_digests() == (0, frozenset())
    assert srv.mesh_label is None


def test_device_pins_the_server_and_shares_params(model):
    """`device=` places the server and its pool there and moves params
    with .to (no copy when already there); a device this process does
    not have raises, never falling back."""
    dec, params, _, _ = model
    srv = PagedDecodeServer(dec, params, device="cpu", **KNOBS)
    assert srv.device == CPU and srv.dec.device == CPU
    assert srv.params["token_embedding"] is params["token_embedding"]
    assert srv.pool_k.device == CPU
    bad = "cuda:0" if not torch.cuda.is_available() else \
        f"cuda:{torch.cuda.device_count()}"
    with pytest.raises((RuntimeError, ValueError), match="device"):
        PagedDecodeServer(dec, params, device=bad, **KNOBS)
    with pytest.raises(ValueError, match="mutually exclusive"):
        PagedDecodeServer(dec, params, device="cpu", mesh=object(), **KNOBS)


def test_fleet_placement_knobs(model):
    """model_axis_size= below 1 is refused; without a card and without
    devices= the front end raises instead of picking the CPU."""
    dec, params, _, _ = model
    with pytest.raises(ValueError, match="model_axis_size"):
        FleetFrontend(dec, params, devices=DEVS, model_axis_size=0, **KNOBS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetFrontend(dec, params, **KNOBS)


# -- the router ladder ------------------------------------------------------


def _router(n=2, **kw):
    obs = _fresh_obs(n)
    board = AdvertisementBoard(n)
    return PrefixRouter(board, obs, **kw), board, obs


def _toks(n_tokens=8):
    return np.arange(n_tokens, dtype=np.int64).reshape(1, -1)


def test_chain_digests_equal_the_jax_package(model):
    """The router and both packages' caches must agree bit for bit: the
    same digests from a tensor, an int32 array and the JAX function."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 32000, size=(1, 70))
    want = jax_chain_digests(jnp.asarray(toks, jnp.int32), 4, 16)
    assert chain_digests(torch.tensor(toks), 4, 16) == want
    assert chain_digests(toks.astype(np.int32), 4, 16) == want
    assert len(want) == 4 and len(set(want)) == 4


def test_router_tie_break_is_deterministic():
    """Equal depth + equal load picks the SAME replica every call (the
    lower index), as the JAX router does on the same board."""
    router, board, _ = _router()
    jobs = JaxFleetMetrics(2)
    for i in range(2):
        jobs.queue_depth[i].set(0)
        jobs.inflight[i].set(0)
        jobs.pool_free[i].set(0)
    jboard = JaxBoard(2)
    jrouter = JaxRouter(jboard, jobs)
    keys = chain_digests(_toks(), 2, 4)
    for b in (board, jboard):
        b.publish(0, 1, frozenset(keys))
        b.publish(1, 1, frozenset(keys))
    for _ in range(5):
        d = router.route(_toks(), 2, 4, [True, True])
        j = jrouter.route(_toks(), 2, 4, [True, True])
        assert (d.replica, d.reason, d.depth) == (0, "prefix", 2)
        assert (j.replica, j.reason, j.depth, j.keys) == (
            d.replica, d.reason, d.depth, d.keys)
        assert d.keys == keys


def test_router_routes_least_loaded_when_no_prefix():
    router, _, obs = _router()
    d = router.route(_toks(), 2, 4, [True, True])
    assert (d.replica, d.reason) == (0, "load")  # tie -> lower index
    obs.queue_depth[0].set(3)
    d = router.route(_toks(), 2, 4, [True, True])
    assert (d.replica, d.reason) == (1, "load")


def test_router_dead_holder_is_fallback_not_load():
    router, board, _ = _router()
    board.publish(0, 1, frozenset(chain_digests(_toks(), 2, 4)))
    d = router.route(_toks(), 2, 4, [False, True])
    assert (d.replica, d.reason, d.depth) == (1, "fallback", 2)


def test_router_migrates_off_overloaded_holder():
    router, board, obs = _router(migrate_gap=4)
    keys = chain_digests(_toks(), 2, 4)
    board.publish(0, 1, frozenset(keys))
    obs.queue_depth[0].set(10)
    d = router.route(_toks(), 2, 4, [True, True])
    assert (d.replica, d.reason, d.source) == (1, "migrate", 0)
    assert d.keys == keys
    # Below the gap the holder keeps the request.
    obs.queue_depth[0].set(3)
    d = router.route(_toks(), 2, 4, [True, True])
    assert (d.replica, d.reason) == (0, "prefix")


def test_router_migrate_disabled_falls_back():
    router, board, obs = _router(migrate=False)
    board.publish(0, 1, frozenset(chain_digests(_toks(), 2, 4)))
    obs.queue_depth[0].set(10)
    d = router.route(_toks(), 2, 4, [True, True])
    assert (d.replica, d.reason) == (1, "fallback")


def test_router_round_robin_rotates_over_live():
    router, _, _ = _router(policy="round_robin")
    seq = [router.route(_toks(), 2, 4, [True, True]).replica
           for _ in range(4)]
    assert seq == [0, 1, 0, 1]
    assert router.route(_toks(), 2, 4, [False, True]).replica == 1


def test_router_rejects_bad_policy_and_empty_fleet():
    with pytest.raises(ValueError, match="policy"):
        _router(policy="random")
    router, _, _ = _router()
    with pytest.raises(RuntimeError, match="no live replicas"):
        router.route(_toks(), 2, 4, [False, False])


# -- admission and shedding -------------------------------------------------


def test_admission_rolling_p99_and_pop():
    ctl = AdmissionController(1, _fresh_obs(1), slo_s=None)
    assert ctl.wait_p99(0) == 0.0
    assert ctl.try_pop(0) is None
    ctl.admit(0, "a")
    assert ctl.depth(0) == 1
    assert ctl.try_pop(0) == "a"
    assert ctl.depth(0) == 0
    ctl2 = AdmissionController(1, _fresh_obs(1))
    for w in [0.01] * 99 + [5.0]:
        ctl2.record_wait(0, w)
    assert ctl2.wait_p99(0) == 5.0  # the tail sample IS the p99


def test_shed_on_slo_is_synchronous(model):
    """Once the rolling queue-wait p99 exceeds the SLO, submit() raises
    a typed ShedError at once, and the shed request's future is gone."""
    fe = _frontend(model, n_replicas=2, slo_s=0.01)
    try:
        for i in range(2):
            fe.controller.record_wait(i, 0.5)
        t0 = time.monotonic()
        with pytest.raises(ShedError) as ei:
            fe.submit(torch.tensor([[5, 1]]), 4)
        assert time.monotonic() - t0 < 1.0
        assert ei.value.reason == "slo"
        assert ei.value.wait_p99_s == pytest.approx(0.5)
        assert fe.stats()["shed"]["slo"] == 1
        with pytest.raises(KeyError):
            fe.result(0)
    finally:
        fe.close()


def test_shed_on_full_queue_never_hangs(model):
    """Held replicas + bounded queues: the overflow submit is rejected
    within the enqueue deadline, and the admitted backlog still drains
    once the replicas resume, with serve_paged's tokens."""
    dec, params, _, _ = model
    fe = _frontend(model, n_replicas=2, max_queue=1, enqueue_wait_s=0.05)
    try:
        _hold_all(fe)
        reqs = _requests(dec.cfg.vocab_size)
        g0 = fe.submit(*reqs[0])
        g1 = fe.submit(*reqs[1])
        t0 = time.monotonic()
        with pytest.raises(ShedError) as ei:
            fe.submit(*reqs[2])
        assert time.monotonic() - t0 < 5.0
        assert ei.value.reason == "queue_full"
        for r in fe.replicas:
            r.hold_admissions = False
        mono, _ = serve_paged(dec, params, reqs[:2], **KNOBS)
        _same([fe.result(g0, timeout=60), fe.result(g1, timeout=60)], mono)
    finally:
        fe.close()


# -- replica death ----------------------------------------------------------


def test_replica_death_reroutes_queued_requests(model):
    """Requests parked in a dead replica's admission queue re-route and
    complete with a healthy fleet's tokens; a cross-thread op against
    the dead replica is loud."""
    dec, params, _, _ = model
    reqs = _requests(dec.cfg.vocab_size)
    fe = _frontend(model, n_replicas=2)
    try:
        _hold_all(fe)
        gid = fe.submit(*reqs[0])
        victim = next(i for i in range(2) if fe.controller.depth(i) == 1)
        survivor = 1 - victim
        fe.replicas[victim].inject_failure(RuntimeError("boom"))
        _wait_until(lambda: fe.replicas[victim].dead is not None,
                    msg="replica death")
        assert not fe.alive[victim]
        fe.replicas[survivor].hold_admissions = False
        mono, _ = serve_paged(dec, params, reqs[:1], **KNOBS)
        _same([fe.result(gid, timeout=60)], mono)
        g2 = fe.submit(*reqs[1])
        fe.result(g2, timeout=60)
        stats = fe.stats()
        assert stats["replicas"][victim]["dead"] is not None
        assert stats["replicas"][survivor]["dead"] is None
        with pytest.raises(ReplicaDeadError):
            fe.replicas[victim].call(lambda srv: srv.ticks)
    finally:
        fe.close()


def test_replica_death_fails_inflight_requests(model):
    """In-flight requests died with the server's pool: they surface as
    ReplicaDeadError from result(), never a silent retry."""
    fe = _frontend(model, n_replicas=2, num_blocks=32)
    try:
        gid = fe.submit(torch.tensor([[5, 1, 7, 2]]), 50)
        box = {}

        def seated():
            for i, r in enumerate(fe.replicas):
                if r.inflight_gids:
                    box["victim"] = i
                    return True
            return False

        _wait_until(seated, msg="request in flight")
        fe.replicas[box["victim"]].inject_failure(RuntimeError("pool gone"))
        with pytest.raises(ReplicaDeadError, match="pool gone"):
            fe.result(gid, timeout=60)
    finally:
        fe.close()


def test_last_replica_death_fails_queued_requests(model):
    """With no survivors, queued requests fail typed instead of waiting
    forever."""
    fe = _frontend(model, n_replicas=1)
    try:
        _hold_all(fe)
        gid = fe.submit(torch.tensor([[5, 1]]), 4)
        fe.replicas[0].inject_failure(RuntimeError("boom"))
        with pytest.raises((RuntimeError, ReplicaDeadError)):
            fe.result(gid, timeout=60)
    finally:
        fe.close()


# -- prefix routing and migration -------------------------------------------


def _holder(fe, timeout=10.0):
    """Index of the replica whose advertisement is non-empty."""
    box = {}

    def some():
        for i, (_, dig, _) in enumerate(fe.board.snapshot()):
            if dig:
                box["idx"] = i
                return True
        return False

    _wait_until(some, timeout, "a digest advertisement")
    return box["idx"]


def test_prefix_routing_follows_the_cache(model):
    """After one request seeds a replica's radix cache, a same-prefix
    request routes to the holder by reason 'prefix' and reuses the
    resident blocks."""
    fe = _frontend(model, n_replicas=2, prefix_cache=True)
    shared = torch.tensor(SHARED)
    try:
        fe.result(fe.submit(shared, 5), timeout=60)
        holder = _holder(fe)
        saved0 = fe.replicas[holder].srv.prefill_tokens_saved
        p2 = torch.cat([shared, torch.tensor([[7, 7]])], dim=1)
        fe.result(fe.submit(p2, 4), timeout=60)
        assert fe.routed["prefix"] == 1
        assert fe.replicas[holder].srv.prefill_tokens_saved > saved0
    finally:
        fe.close()


def test_migration_moves_blocks_and_keeps_tokens(model):
    """An overloaded holder's prefix chain ships to the least-loaded
    replica and the rerouted request's tokens equal serve_paged's."""
    dec, params, _, _ = model
    shared = torch.tensor(SHARED)
    p2 = torch.cat([shared, torch.tensor([[7, 7]])], dim=1)
    ref, _ = serve_paged(dec, params, [(p2, 4)], prefix_cache=True, **KNOBS)
    fe = _frontend(model, n_replicas=2, prefix_cache=True, migrate_gap=4)
    try:
        fe.result(fe.submit(shared, 5), timeout=60)
        holder = _holder(fe)
        # A fake backlog on the holder: the queue_depth gauge is
        # admission-owned, so the replica loop won't overwrite it.
        fe.obs.queue_depth[holder].set(10)
        out = fe.result(fe.submit(p2, 4), timeout=60)
        assert fe.routed["migrate"] == 1
        assert fe.migrated_blocks == 2  # the prompt's two full blocks
        _same([out], ref)
        _, dig = fe.replicas[1 - holder].srv.resident_digests()
        assert set(chain_digests(shared, 2, 4)) <= dig
    finally:
        fe.close()


def _seeded_pair(model, kv_dtype, num_blocks=16):
    """A port and a JAX server that each served SHARED once (its two
    full blocks parked in the radix cache)."""
    dec, params, jdec, jparams = model
    kw = dict(KNOBS, num_blocks=num_blocks, prefix_cache=True,
              kv_dtype=kv_dtype)
    srv = PagedDecodeServer(dec, params, **kw)
    jsrv = JaxPagedServer(jdec, jparams, **kw)
    srv.submit(torch.tensor(SHARED), 3)
    srv.run()
    jsrv.submit(jnp.asarray(SHARED, jnp.int32), 3)
    jsrv.run()
    return srv, jsrv


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_export_import_match_the_jax_server(model, kv_dtype):
    """export_prefix_blocks gives the JAX server's token bytes and block
    stacks (f32, within 1e-5: the two packages' f32 roundoff; int8
    pools dequantize), import_prefix_blocks seats
    them with the JAX server's count and radix state, skips a resident
    chain, and a migrated chain serves serve_paged's tokens."""
    dec, params, jdec, jparams = model
    srv, jsrv = _seeded_pair(model, kv_dtype)
    keys = chain_digests(torch.tensor(SHARED), 2, 4)
    toks, k, v = srv.export_prefix_blocks(keys)
    jtoks, jk, jv = jsrv.export_prefix_blocks(keys)
    assert toks == jtoks
    assert k.dtype == torch.float32 and tuple(k.shape) == jk.shape
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    assert srv.export_prefix_blocks([b"\0" * 16]) is None
    assert srv.import_prefix_blocks(toks, k, v) == 0  # already resident
    kw = dict(KNOBS, prefix_cache=True, kv_dtype=kv_dtype)
    dst = PagedDecodeServer(dec, params, **kw)
    jdst = JaxPagedServer(jdec, jparams, **kw)
    assert dst.import_prefix_blocks(toks, k, v) == 2
    assert jdst.import_prefix_blocks(jtoks, jk, jv) == 2
    assert dst.resident_digests()[1] == jdst.resident_digests()[1]
    assert len(dst.radix.lru) == len(jdst.radix.lru) == 2
    assert len(dst.free) == len(jdst.free)
    p2 = torch.cat([torch.tensor(SHARED), torch.tensor([[7, 7]])], dim=1)
    rid = dst.submit(p2, 4)
    got = dst.run()[rid]
    assert dst.prefill_tokens_saved == 8
    ref, _ = serve_paged(dec, params, [(p2, 4)], **kw)
    _same([got], ref, kv_dtype)


def test_import_truncates_the_tail_under_pressure(model):
    """A pool that cannot hold the chain keeps its shallow end, as the
    JAX server does; a wrong stack shape is loud."""
    dec, params, jdec, jparams = model
    srv, _ = _seeded_pair(model, "fp")
    keys = chain_digests(torch.tensor(SHARED), 2, 4)
    toks, k, v = srv.export_prefix_blocks(keys)
    kw = dict(KNOBS, num_blocks=2, prefix_cache=True)
    dst = PagedDecodeServer(dec, params, **kw)
    jdst = JaxPagedServer(jdec, jparams, **kw)
    assert dst.import_prefix_blocks(toks, k, v) == 1
    assert jdst.import_prefix_blocks(toks, k.numpy(), v.numpy()) == 1
    assert dst.resident_digests()[1] == jdst.resident_digests()[1]
    with pytest.raises(ValueError, match="block stack shape"):
        dst.import_prefix_blocks(toks[:1], k, v)


# -- the prefix payload wire ------------------------------------------------


def _payload_arrays(dtype=np.float32):
    rng = np.random.default_rng(5)
    toks = [np.arange(4, dtype=np.int64).tobytes(),
            np.arange(4, 8, dtype=np.int64).tobytes()]
    k = rng.standard_normal((3, 2, 2, 4, 8)).astype(dtype)
    v = rng.standard_normal((3, 2, 2, 4, 8)).astype(dtype)
    return toks, k, v


def test_prefix_payload_is_the_jax_bytes():
    """The same chain framed by each package is the same bytes on the
    socket, and the same wire byte count."""
    toks, k, v = _payload_arrays()
    sent = {}

    def port(sender):
        sent["port"] = wire.send_prefix_payload(
            sender, wire.PrefixPayload(toks, torch.from_numpy(k),
                                       torch.from_numpy(v)))

    def jax_side(sender):
        sent["jax"] = jwire.send_prefix_payload(
            sender, jwire.PrefixPayload(toks=toks, k=k, v=v))

    got = _captured(port, transport.ArraySender)
    want = _captured(jax_side, jtransport.ArraySender)
    assert got == want
    assert sent["port"] == sent["jax"]


def _loopback(recv_cls, read, send_cls, send):
    """One payload over real sockets: `send(sender)` on one package's
    sender, `read(iterator, receiver)` on the other's receiver."""
    recv = recv_cls(0, host="127.0.0.1", accept_timeout_s=10.0)
    got = []
    t = threading.Thread(target=lambda: got.append(read(iter(recv), recv)))
    t.start()
    sender = send_cls("127.0.0.1", recv.port)
    n = send(sender)
    sender.close()
    t.join(timeout=10)
    recv.close()
    return got[0], n, recv.rx_frame_bytes


def test_prefix_payload_reads_both_ways():
    """A port payload read by the JAX reader and a JAX payload read by
    the port's are lossless, with the wire bytes accounted on both."""
    toks, k, v = _payload_arrays()
    out, n, rx = _loopback(
        jtransport.ArrayReceiver, jwire.read_prefix_payload,
        transport.ArraySender,
        lambda s: wire.send_prefix_payload(
            s, wire.PrefixPayload(toks, torch.from_numpy(k),
                                  torch.from_numpy(v))))
    assert out.toks == toks
    np.testing.assert_array_equal(out.k, k)
    np.testing.assert_array_equal(out.v, v)
    assert out.wire_bytes == n == rx
    out, n, rx = _loopback(
        transport.ArrayReceiver, wire.read_prefix_payload,
        jtransport.ArraySender,
        lambda s: jwire.send_prefix_payload(
            s, jwire.PrefixPayload(toks=toks, k=k, v=v)))
    assert out.toks == toks
    np.testing.assert_array_equal(out.k.numpy(), k)
    np.testing.assert_array_equal(out.v.numpy(), v)
    assert out.wire_bytes == n == rx


def test_prefix_payload_bf16_round_trip_is_lossless():
    """bf16 stacks cross as their 2-byte pattern under the dtype token
    'bfloat16' and come back bit-identical."""
    toks, k, v = _payload_arrays()
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    out, n, rx = _loopback(
        transport.ArrayReceiver, wire.read_prefix_payload,
        transport.ArraySender,
        lambda s: wire.send_prefix_payload(s, wire.PrefixPayload(toks, kb,
                                                                 vb)))
    assert out.k.dtype == torch.bfloat16
    assert torch.equal(out.k, kb) and torch.equal(out.v, vb)
    assert out.wire_bytes == n == rx


def test_prefix_payload_toks_shape_mismatch_is_loud():
    pay = wire.PrefixPayload(
        toks=[b"x"],
        k=torch.zeros((1, 2, 1, 4, 2)),
        v=torch.zeros((1, 2, 1, 4, 2)),
    )
    with pytest.raises(ValueError, match="token blobs"):
        wire.send_prefix_payload(object(), pay)
