"""`serve_fleet()`: N paged decode replicas behind one front door.
Counterpart of `defer_tpu/fleet/api.py`, with the same knobs and the
same `serve_paged` contract.

The front-end owns the three cooperating pieces: the router
(fleet/router.py — prefix-aware placement over replica digest
advertisements), the admission controller (fleet/admission.py —
bounded queues + SLO shedding), and the replicas (fleet/replica.py —
one `PagedDecodeServer` per serving thread). `serve_fleet` keeps the
`serve_paged` contract — (outputs in submission order, stats) — and at
`n_replicas=1` with default knobs is token-identical to it: one
replica, nothing to route, unbounded queue, no SLO, so every request
takes the same `submit -> admit -> tick` path on the same server
class.

Replica placement defaults to in-process threads; pass
`spawn_replica(idx, make_server, controller, board, obs, *, on_done,
on_fail, on_dead)` returning a ThreadReplica-shaped object to place
replicas elsewhere (the `spawn_worker=` pattern from disagg/api.py).

Replica <-> devices contract: `make_server` takes the replica index
and returns that replica's server ALREADY PLACED — the spawner never
picks devices itself, it only decides where the thread/process runs.
The in-process default places replica i on `devs[i % len(devs)]`, where
`devs` is the `devices=` list or every CUDA device of the process (none
raises: pass CPU devices to run on the CPU), so replicas that outnumber
the cards share them: on one card every replica is a `device=` server
on it, each with its own pool and all reading one set of weights
(`.to` moves nothing that is already there).

Tensor-parallel replicas, `model_axis_size=m`: replica i takes the
device chunk `devs[(i * m + j) % len(devs)]` for j < m, wrapping around
(the JAX package's placement), and serves on its own `{"model": m}`
mesh over the ranks of a `torch.distributed` group of m ranks
(`parallel/multihost.py` `initialize`), each mesh with its own process
groups, so two replicas' seams never share one. Every rank calls
`serve_fleet` (or builds the `FleetFrontend`) with the same arguments
and the whole params; the controller (rank 0) routes and serves, and
every other rank runs each replica's follower loop in a thread of its
own (`FollowerReplica`) until the controller closes the fleet. The
replicas of a rank share one shard of the tree (runtime/paged.py).

Failure semantics: a dead replica fails its in-flight requests with
`ReplicaDeadError` (their KV died with the pool — silently re-running
them would hide a real outage), re-routes its still-queued requests to
surviving replicas, and drops out of the routing set. Shedding raises
`ShedError` from `submit()` — admission rejections are synchronous and
typed, never a hang.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import torch

from defer_tpu_torch.disagg.wire import PrefixPayload
from defer_tpu_torch.fleet.admission import AdmissionController, ShedError
from defer_tpu_torch.fleet.replica import (
    FollowerReplica,
    ReplicaDeadError,
    ThreadReplica,
)
from defer_tpu_torch.fleet.router import AdvertisementBoard, PrefixRouter
from defer_tpu_torch.obs.serving import FleetMetrics, FleetStats, ServerStats
from defer_tpu_torch.parallel.mesh import cuda_devices, make_mesh
from defer_tpu_torch.runtime.paged import PagedDecodeServer
from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class _FleetRequest:
    gid: int
    prompt: Any
    steps: int
    sampling: Any = None
    stop: Any = None


class FleetFrontend:
    """Construct replicas, route, admit, await. One instance per
    serving session; `close()` stops the replica threads. With
    `model_axis_size=` over a process group, `follower` is True on every
    rank but the controller: its replicas follow the controller's
    dispatches, and `close()` waits for the controller to close them."""

    def __init__(
        self,
        dec: Any,
        params: dict,
        *,
        n_replicas: int = 1,
        num_blocks: int,
        block_size: int = 16,
        max_batch: int = 4,
        eos_id: int | None = None,
        prefix_cache: bool = False,
        attention: str = "gathered",
        kv_dtype: str = "fp",
        spill_bytes: int = 0,
        prefill_chunk: int | None = None,
        decode_window: int = 1,
        spec_k: int = 0,
        spec_draft: Any = None,
        spec_params: dict | None = None,
        policy: str = "prefix",
        slo_s: float | None = None,
        max_queue: int = 0,
        enqueue_wait_s: float = 0.05,
        migrate: bool = True,
        migrate_gap: int = 4,
        spawn_replica: Any = None,
        model_axis_size: int | None = None,
        devices: list | None = None,
        constraints: dict | None = None,
    ):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.n_replicas = n_replicas
        self.block_size = block_size
        self.policy = policy
        self.obs = FleetMetrics(n_replicas)
        # The obs registry is process-global and instruments are
        # shared by (name, labels): zero the per-replica gauges up
        # front so a previous fleet's parting values can't steer this
        # run's first routing decisions.
        for i in range(n_replicas):
            self.obs.queue_depth[i].set(0)
            self.obs.inflight[i].set(0)
            self.obs.pool_free[i].set(0)
        self.controller = AdmissionController(
            n_replicas,
            self.obs,
            max_queue=max_queue,
            slo_s=slo_s,
            enqueue_wait_s=enqueue_wait_s,
        )
        self.board = AdvertisementBoard(n_replicas)
        self.router = PrefixRouter(
            self.board,
            self.obs,
            policy=policy,
            migrate=migrate,
            migrate_gap=migrate_gap,
        )
        self.alive = [True] * n_replicas

        # Device placement (module docstring): replica i's device, or its
        # model_axis_size-device mesh, comes from its index, wrapping
        # around when replicas outnumber the devices.
        if model_axis_size is not None and model_axis_size < 1:
            raise ValueError(
                f"model_axis_size must be >= 1, got {model_axis_size}"
            )
        devs = list(devices) if devices is not None else cuda_devices()
        if not devs:
            raise ValueError("devices= is empty")

        def placement(i: int) -> dict:
            if model_axis_size is None:
                return {"device": devs[i % len(devs)]}
            m = model_axis_size
            chunk = [devs[(i * m + j) % len(devs)] for j in range(m)]
            return {"mesh": make_mesh({"model": m}, chunk)}

        # Built here, in replica order, on every rank: a mesh over the
        # ranks makes its process groups collectively.
        places = [placement(i) for i in range(n_replicas)]

        def make_server(i: int) -> PagedDecodeServer:
            return PagedDecodeServer(
                dec,
                params,
                num_blocks=num_blocks,
                block_size=block_size,
                max_batch=max_batch,
                eos_id=eos_id,
                prefix_cache=prefix_cache,
                attention=attention,
                kv_dtype=kv_dtype,
                spill_bytes=spill_bytes,
                prefill_chunk=prefill_chunk,
                decode_window=decode_window,
                spec_k=spec_k,
                spec_draft=spec_draft,
                spec_params=spec_params,
                constraints=constraints,
                **places[i],
            )

        mesh0 = places[0].get("mesh")
        self.follower = (mesh0 is not None and mesh0.distributed
                         and mesh0.rank != mesh0.origin)
        spawn = spawn_replica or ThreadReplica
        if self.follower:
            spawn = FollowerReplica
        self.replicas = [
            spawn(
                i,
                make_server,
                self.controller,
                self.board,
                self.obs,
                on_done=self._complete,
                on_fail=self._fail,
                on_dead=self._on_dead,
            )
            for i in range(n_replicas)
        ]
        self._lock = threading.RLock()
        self._results: dict[int, dict] = {}
        self._next_gid = 0
        self.routed = {r: 0 for r in FleetMetrics.ROUTE_REASONS}
        self.shed = {r: 0 for r in FleetMetrics.SHED_REASONS}
        self.migrated_blocks = 0
        for r in self.replicas:
            r.start()

    # -- result plumbing (called from replica threads) ---------------------

    def _complete(self, gid: int, tokens: Any) -> None:
        slot = self._results.get(gid)
        if slot is None:
            return
        slot["val"] = tokens
        slot["event"].set()

    def _fail(self, gid: int, exc: BaseException) -> None:
        slot = self._results.get(gid)
        if slot is None:
            return
        slot["exc"] = exc
        slot["event"].set()

    def _on_dead(self, idx: int, exc: BaseException) -> None:
        """Replica-death protocol: drop it from routing, then re-route
        everything still parked in its admission queue (never touched
        by the dead server). Runs on the dying replica's thread."""
        log.warning("fleet replica %d died: %s", idx, exc)
        with self._lock:
            self.alive[idx] = False
            queued = self.controller.drain(idx)
        for req in queued:
            try:
                self._route_and_admit(req)
            except (ShedError, RuntimeError, ReplicaDeadError) as e:
                self._fail(req.gid, e)

    # -- routing -----------------------------------------------------------

    def _do_migrate(self, decision) -> bool:
        """Ship the decided prefix chain source -> target as a
        disagg/wire PrefixPayload (the importer recomputes the chained
        digests from the payload's token bytes). Both ends run on
        their own serving threads via replica ops. False = anything
        went stale or broke; the caller downgrades to fallback."""
        src = self.replicas[decision.source]
        dst = self.replicas[decision.replica]
        keys = decision.keys
        try:
            exported = src.call(
                lambda srv: srv.export_prefix_blocks(keys)
            )
            if exported is None:
                return False  # evicted since the advertisement
            toks, k, v = exported
            payload = PrefixPayload(toks=toks, k=k, v=v)
            n = dst.call(
                lambda srv: srv.import_prefix_blocks(
                    payload.toks, payload.k, payload.v
                )
            )
        except (ReplicaDeadError, TimeoutError) as e:
            log.warning("prefix migration failed: %s", e)
            return False
        if n:
            self.obs.migrated_blocks.inc(n)
            self.migrated_blocks += n
        return True

    def _route_and_admit(self, req: _FleetRequest) -> None:
        with self._lock:
            t0 = int(req.prompt.shape[1])
            decision = self.router.route(
                req.prompt,
                t0 // self.block_size,
                self.block_size,
                self.alive,
            )
            if decision.reason == "migrate":
                if not self._do_migrate(decision):
                    decision.reason = "fallback"
            self.obs.routed[decision.reason].inc()
            self.routed[decision.reason] += 1
            try:
                self.controller.admit(decision.replica, req)
            except ShedError as e:
                self.shed[e.reason] = self.shed.get(e.reason, 0) + 1
                raise

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt_ids: Any,
        num_steps: int,
        *,
        sampling: Any = None,
        stop: Any = None,
    ) -> int:
        """Route + enqueue one request; returns a fleet-wide id for
        `result()`. Raises ShedError synchronously when admission
        rejects it (the future is cleaned up — a shed request can
        never be waited on into a hang)."""
        if self.follower:
            raise RuntimeError(
                "submit runs on the fleet's controller (rank 0 of its "
                "meshes); this rank's replicas follow its dispatches"
            )
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] != 1:
            raise ValueError("submit one request at a time ([1, T])")
        with self._lock:
            gid = self._next_gid
            self._next_gid += 1
        self._results[gid] = {"event": threading.Event()}
        req = _FleetRequest(gid, prompt_ids, num_steps, sampling, stop)
        try:
            self._route_and_admit(req)
        except ShedError:
            del self._results[gid]
            raise
        return gid

    def result(self, gid: int, timeout: float | None = None) -> Any:
        """Block until request `gid` finishes; returns its [1, T]
        token array or raises the request's typed failure
        (ReplicaDeadError et al)."""
        slot = self._results.get(gid)
        if slot is None:
            raise KeyError(f"unknown or shed request {gid}")
        if not slot["event"].wait(timeout):
            raise TimeoutError(f"request {gid} not done in {timeout}s")
        del self._results[gid]
        if "exc" in slot:
            raise slot["exc"]
        return slot["val"]

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def stats(self) -> FleetStats:
        """Fleet-level snapshot plus per-replica ServerStats (the same
        fields `serve_paged` reports), replica-index order; dead
        replicas report `dead` with the cause."""
        per = []
        for r in self.replicas:
            srv = r.srv
            per.append(
                ServerStats.snapshot(
                    srv.obs.registry,
                    ticks=srv.ticks,
                    attention=srv.attention,
                    peak_blocks=srv.blocks_peak,
                    pool_blocks=srv.num_blocks - 1,
                    block_size=srv.bs,
                    decode_window=srv.decode_window,
                    host_dispatches=srv.dispatches,
                    cached_blocks=(
                        srv.radix.cached_blocks
                        if srv.radix is not None
                        else 0
                    ),
                    prefill_tokens_saved=srv.prefill_tokens_saved,
                    prefill_budget=srv.prefill_budget,
                    prefill_stall_ticks=srv.prefill_stall_ticks_n,
                    mixed_ticks=srv.mixed_ticks_n,
                    mixed_prefill_tokens=srv.mixed_prefill_tokens_n,
                    decode_stall_fraction=(
                        srv.decode_stall_fraction_last
                    ),
                    mesh_shape=srv.mesh_label,
                    tp_psums=srv.tp_psums,
                    kv_dtype=srv.kv_dtype,
                    pool_bytes=srv.pool_bytes,
                    spec_k=srv.spec_k,
                    spec_rounds=srv.spec_rounds_n,
                    spec_proposed=srv.spec_proposed_n,
                    spec_accepted=srv.spec_accepted_n,
                    spec_acceptance=(
                        srv.spec_accepted_n / srv.spec_proposed_n
                        if srv.spec_proposed_n
                        else 0.0
                    ),
                    spec_draft_tokens=srv.spec_draft_tokens_n,
                    spilled_blocks=(
                        srv._spill.stored_blocks
                        if srv._spill is not None
                        else 0
                    ),
                    spill_hits=srv.spill_hits_n,
                    constrained_tokens=srv.constrained_tokens_n,
                    constraint_dead_ends=srv.constraint_dead_ends_n,
                    dead=str(r.dead) if r.dead is not None else None,
                )
            )
        return FleetStats.snapshot(
            self.obs.registry,
            n_replicas=self.n_replicas,
            policy=self.policy,
            routed=dict(self.routed),
            shed=dict(self.shed),
            migrated_blocks=self.migrated_blocks,
            replicas=per,
        )


def serve_fleet(
    dec: Any,
    params: dict,
    requests: list[tuple[torch.Tensor, int]],
    *,
    n_replicas: int = 1,
    num_blocks: int,
    block_size: int = 16,
    max_batch: int = 4,
    eos_id: int | None = None,
    prefix_cache: bool = False,
    attention: str = "gathered",
    kv_dtype: str = "fp",
    spill_bytes: int = 0,
    prefill_chunk: int | None = None,
    decode_window: int = 1,
    spec_k: int = 0,
    spec_draft: Any = None,
    spec_params: dict | None = None,
    sampling: list | None = None,
    stop: list | None = None,
    policy: str = "prefix",
    slo_s: float | None = None,
    max_queue: int = 0,
    migrate: bool = True,
    migrate_gap: int = 4,
    spawn_replica: Any = None,
    model_axis_size: int | None = None,
    devices: list | None = None,
    result_timeout_s: float = 600.0,
    constraints: dict | None = None,
) -> tuple[list[torch.Tensor], dict]:
    """One-shot fleet serving; same contract as `serve_paged` (outputs
    in submission order + stats) over `n_replicas` paged servers, each
    sized `num_blocks`/`max_batch` on its own. Default knobs shed
    nothing (unbounded queues, no SLO) — overload policy is opt-in via
    `slo_s`/`max_queue`, and a ShedError then propagates to the
    caller. Returns FleetStats: routing-reason and shed counts,
    migrated block totals, and per-replica ServerStats.

    Placement: replica i serves on `devices[i % len(devices)]` (default:
    every CUDA device of the process); `model_axis_size=m` gives each
    replica its own m-device "model" mesh over a process group of m
    ranks and serves it tensor-parallel (module docstring). Then every
    rank calls serve_fleet with the same arguments: the controller
    serves and returns the outputs; every other rank follows its
    replicas' dispatches and returns an empty list (with its stats).

    `prefill_chunk` (a knob the JAX package's fleet does not pass on)
    runs every replica's admission prefill pool-native in chunks of that
    many tokens, as on `serve_paged`; a radix hit a whole number of
    chunks long then leaves the suffix's chunks where a miss puts them,
    so bf16 outputs stay token-identical whichever replica serves.

    `kv_dtype`/`spill_bytes` apply to every replica's pool
    (PagedDecodeServer docstring). Prefix-block migration between
    replicas is dtype-transparent: export dequantizes to the wire's
    compute dtype and the importing replica's pool requantizes on
    landing, so mixed-pool fleets still migrate.

    `spec_k`/`spec_draft`/`spec_params` turn on speculative decoding
    on EVERY replica (each gets its own DraftLanes over its own
    devices). Migration composes for free: only TARGET prefix blocks
    ship between pools, and the admitting replica's draft lane always
    re-prefills the full prompt locally (radix hits are a pool
    concept the draft does not share), so a migrated admission
    speculates exactly like a local one. A dying replica's draft
    lanes are torn down with its pool (`DraftLanes.release_all` in
    the replica loop's failure path).

    `constraints={name: TokenDFA}` registers compiled grammars on
    EVERY replica (defer_tpu_torch/constrain/): each replica stacks its own
    device copy of the DFA tables, so a request opting in via
    `SamplingParams(constraint="name")` decodes constrained on
    whichever replica the router picks (migration ships prefix
    blocks, never sampler state — a request's DFA walk lives and dies
    on its admitting replica). Per-replica ServerStats then carry
    `constrained_tokens` / `constraint_dead_ends`."""
    fe = FleetFrontend(
        dec,
        params,
        n_replicas=n_replicas,
        num_blocks=num_blocks,
        block_size=block_size,
        max_batch=max_batch,
        eos_id=eos_id,
        prefix_cache=prefix_cache,
        attention=attention,
        kv_dtype=kv_dtype,
        spill_bytes=spill_bytes,
        prefill_chunk=prefill_chunk,
        decode_window=decode_window,
        spec_k=spec_k,
        spec_draft=spec_draft,
        spec_params=spec_params,
        policy=policy,
        slo_s=slo_s,
        max_queue=max_queue,
        migrate=migrate,
        migrate_gap=migrate_gap,
        spawn_replica=spawn_replica,
        model_axis_size=model_axis_size,
        devices=devices,
        constraints=constraints,
    )
    if fe.follower:
        fe.close()  # returns once the controller has closed the fleet
        return [], fe.stats()
    samps = sampling or [None] * len(requests)
    stops = stop or [None] * len(requests)
    if len(samps) != len(requests) or len(stops) != len(requests):
        raise ValueError(
            "sampling/stop must have one entry per request when given"
        )
    try:
        gids = [
            fe.submit(p, s, sampling=sp, stop=st)
            for (p, s), sp, st in zip(requests, samps, stops)
        ]
        outs = [fe.result(g, timeout=result_timeout_s) for g in gids]
    finally:
        fe.close()
    return outs, fe.stats()
