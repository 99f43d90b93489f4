"""One fleet replica: a `PagedDecodeServer` owned by one serving
thread. Counterpart of `defer_tpu/fleet/replica.py`.

Single-writer discipline (the same split disagg/ingest.py runs): ALL
server state — the pool, the block tables, the radix cache — is
touched exclusively by this replica's serving thread. A tick writes
the pool IN PLACE (a captured window replays into the same storage),
so a reader on any other thread could copy rows mid-write; anything
that must read or mutate server state from outside (the router's
block export/import during a migration) is posted to the `ops` queue
and executed by the loop between ticks. The front-end threads only ever touch the admission
queue (owned by AdmissionController), this replica's ops queue, and
the obs gauges — all designed for cross-thread use.

Loop shape, every iteration:

    drain ops -> pop admissions while the server has room -> _admit ->
    _tick (if anything is seated) -> harvest finished requests ->
    publish a digest advertisement IF the radix generation moved ->
    refresh load gauges

Replica death (any exception out of the loop, including injected test
failures): in-flight requests — already submitted to the dead server,
their KV unrecoverable — fail loudly through `on_fail` with a
`ReplicaDeadError`; requests still parked in the admission queue were
never touched and are the front-end's to re-route (`on_dead`
callback). The dead replica stops advertising and its gauges zero, so
the router stops picking it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Callable

from defer_tpu_torch.runtime.paged import PagedDecodeServer


class ReplicaDeadError(Exception):
    """A request failed because its replica died mid-flight. Carries
    the replica index and the root cause."""

    def __init__(self, replica: int, cause: BaseException | str):
        self.replica = replica
        self.cause = cause
        super().__init__(f"replica {replica} died: {cause}")


class ThreadReplica:
    """Default in-process replica (the fleet twin of disagg/api.py's
    `_thread_worker_spawner`). A `spawn_replica` hook can substitute
    anything exposing the same surface: `start/close/call/
    inject_failure`, `dead`, `hold_admissions`, and `srv`."""

    def __init__(
        self,
        idx: int,
        make_server: Callable[[int], PagedDecodeServer],
        controller: Any,
        board: Any,
        obs: Any,
        *,
        on_done: Callable[[Any, Any], None],
        on_fail: Callable[[Any, BaseException], None],
        on_dead: Callable[[int, BaseException], None],
    ):
        self.idx = idx
        # make_server(idx) returns this replica's server already
        # placed on its device slice (fleet/api.py documents the
        # replica <-> devices contract) — the spawner never picks
        # devices itself.
        self.srv = make_server(idx)
        self.controller = controller
        self.board = board
        self.obs = obs
        self.on_done = on_done
        self.on_fail = on_fail
        self.on_dead = on_dead
        self.ops: "queue_mod.Queue[tuple]" = queue_mod.Queue()
        self.dead: BaseException | None = None
        # Test seams: hold_admissions keeps the loop ticking seated
        # work while never popping the inbox (builds real queue
        # backlog); inject_failure raises inside the loop on its next
        # iteration (replica-death path without monkeypatching).
        self.hold_admissions = False
        self._fail: BaseException | None = None
        self._stop = threading.Event()
        self._gid_of: dict[int, Any] = {}  # rid -> gid, this replica
        self._advert_gen = -1
        self._thread = threading.Thread(
            target=self._loop, name=f"fleet-replica-{idx}", daemon=True
        )

    # -- front-end surface (any thread) -----------------------------------

    def start(self) -> None:
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        # A meshed server's followers (other ranks) end with it.
        self.srv.close()
        if self.srv._spill is not None:
            # Settle the host spill tier's drain thread so its gauges
            # (and any caller reading stored_bytes) see a final value.
            self.srv._spill.close()

    # analysis: domain(any) test seam — one pointer store, read-and-cleared by
    # the loop; tearing is impossible and loss is acceptable
    def inject_failure(self, exc: BaseException) -> None:
        """Test seam: one pointer store, read and cleared by the loop."""
        self._fail = exc

    def call(self, fn: Callable[[PagedDecodeServer], Any],
             timeout: float = 30.0) -> Any:
        """Run `fn(srv)` ON the serving thread and return its result —
        the only sanctioned way to touch server state from outside
        (module docstring). Raises ReplicaDeadError if the replica is
        (or goes) dead, TimeoutError if the loop never picks it up."""
        if self.dead is not None:
            raise ReplicaDeadError(self.idx, self.dead)
        done = threading.Event()
        box: dict[str, Any] = {}
        self.ops.put((fn, done, box))
        if not done.wait(timeout):
            raise TimeoutError(
                f"replica {self.idx} op not serviced in {timeout}s"
            )
        if "exc" in box:
            raise box["exc"]
        return box["val"]

    @property
    def inflight_gids(self) -> list:
        return list(self._gid_of.values())

    # -- serving thread ----------------------------------------------------

    def _drain_ops(self) -> None:
        while True:
            try:
                fn, done, box = self.ops.get_nowait()
            except queue_mod.Empty:
                return
            try:
                box["val"] = fn(self.srv)
            except BaseException as e:  # op errors go to the caller
                box["exc"] = e
            finally:
                done.set()

    def _take(self, req: Any) -> None:
        try:
            rid = self.srv.submit(
                req.prompt,
                req.steps,
                sampling=req.sampling,
                stop=req.stop,
            )
        except Exception as e:
            # A single unserveable request (e.g. larger than the whole
            # pool) fails ITSELF, not the replica.
            self.on_fail(req.gid, e)
            return
        self._gid_of[rid] = req.gid

    def _room(self) -> bool:
        """Pop the inbox only while the server can actually use more
        work (pending + seated < max_batch): requests beyond that wait
        in the admission queue where their wait is measured and
        sheddable, instead of hiding in an unbounded server-side list."""
        srv = self.srv
        seated = sum(1 for s in srv.slots if s is not None)
        return len(srv.pending) + seated < srv.B

    def _harvest(self) -> None:
        srv = self.srv
        for rid in list(self._gid_of):
            if rid in srv.done:
                self.on_done(self._gid_of.pop(rid), srv.done.pop(rid))

    def _publish(self) -> None:
        srv = self.srv
        gen = srv.radix.generation if srv.radix is not None else 0
        if gen == self._advert_gen:
            return  # one int compare — the advertisement fast path
        # Snapshot under the radix lock, publish OUTSIDE it (the board
        # has its own lock).
        gen, digests = srv.resident_digests()
        self.board.publish(self.idx, gen, digests)
        self._advert_gen = gen

    def _gauges(self) -> None:
        srv = self.srv
        seated = sum(1 for s in srv.slots if s is not None)
        self.obs.inflight[self.idx].set(
            len(srv.pending) + len(srv.pending_prefilled) + seated
        )
        headroom = len(srv.free)
        if srv.radix is not None:
            headroom += len(srv.radix.lru)  # parked = evictable
        self.obs.pool_free[self.idx].set(headroom)

    # analysis: domain(serving) the replica's loop IS its serving thread — all
    # srv state is owned here, outside callers go through call()
    def _loop(self) -> None:
        """The serving thread: all srv state is owned here; outside
        callers go through call()."""
        srv = self.srv
        try:
            self._publish()
            self._gauges()
            while not self._stop.is_set():
                self._drain_ops()
                if self._fail is not None:
                    exc, self._fail = self._fail, None
                    raise exc
                progressed = False
                if not self.hold_admissions:
                    while self._room():
                        item = self.controller.try_pop(self.idx)
                        if item is None:
                            break
                        self._take(item)
                        progressed = True
                srv._admit()
                if any(s is not None for s in srv.slots):
                    srv._tick()
                    progressed = True
                self._harvest()
                self._publish()
                self._gauges()
                if progressed or srv.pending:
                    continue
                # Idle: park on the inbox briefly instead of spinning
                # the admit loop hot (disagg/api.py's idle yield).
                if self.hold_admissions:
                    time.sleep(1e-3)
                else:
                    item = self.controller.try_pop(self.idx, timeout=1e-3)
                    if item is not None:
                        self._take(item)
        except BaseException as e:
            self.dead = e
            # Fail queued ops (their callers are blocked on events).
            while True:
                try:
                    _, done, box = self.ops.get_nowait()
                except queue_mod.Empty:
                    break
                box["exc"] = ReplicaDeadError(self.idx, e)
                done.set()
            # In-flight requests die with the server; queued ones are
            # the front-end's to re-route.
            for gid in self._gid_of.values():
                self.on_fail(gid, ReplicaDeadError(self.idx, e))
            self._gid_of.clear()
            if srv._draft is not None:
                # Draft lanes hold per-slot K/V for the dead requests;
                # clear them with the pool so a post-mortem reader (or
                # a spawner that recycles the server object) never
                # sees stale draft state for requests that failed.
                srv._draft.release_all()
            self.obs.inflight[self.idx].set(0)
            self.obs.pool_free[self.idx].set(0)
            self.on_dead(self.idx, e)


class FollowerReplica:
    """A replica on a rank other than its mesh's controller (fleet
    `model_axis_size=` over a process group): its server, built in the
    same order as the controller's, runs the controller's dispatches in
    a thread of its own (`PagedDecodeServer.run`) until the controller's
    replica closes it. Takes ThreadReplica's arguments; routes nothing,
    so the callbacks stay unused."""

    def __init__(self, idx: int, make_server, controller, board, obs, *,
                 on_done, on_fail, on_dead):
        self.idx = idx
        self.srv = make_server(idx)
        self.dead: BaseException | None = None
        self._thread = threading.Thread(
            target=self._follow, name=f"fleet-follower-{idx}", daemon=True
        )

    # analysis: domain(serving) a follower replica's thread is its server's
    # serving thread: it runs the controller's dispatches on the rank's own
    # shards
    def _follow(self) -> None:
        try:
            self.srv.run()
        except Exception as e:  # the thread's boundary: the fleet's stats
            self.dead = e      # report it as the replica's death

    def start(self) -> None:
        self._thread.start()

    def close(self, timeout: float | None = None) -> None:
        """Wait until the controller has closed this replica."""
        self._thread.join(timeout=timeout)
