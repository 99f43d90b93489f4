"""Decode-side KV ingest: receive payloads, seat them in the pool.

Counterpart of `defer_tpu/disagg/ingest.py`. `KVBlockIngest` owns the
result stream from a prefill worker (`disagg/prefill_worker.py`) and
splits the work across two threads by what each may mutate:

  * the DRAIN thread does transport work only: it iterates
    `wire.iter_kv_payloads`, validates each payload against the decode
    server's geometry, and parks it in a `batching.TimedQueue`. It never
    touches the pool or the card.
  * the SERVING thread (whoever runs the decode loop) calls `pump()`
    between ticks: it pops parked payloads, timing their wait into
    `defer_kv_ingest_wait_seconds`, and hands each to
    `PagedDecodeServer.deliver_kv`. Every pool and block-table write
    stays on the serving thread, the single writer the server's own
    admission relies on.

Payloads stay in the wire's compute dtype on the host until admission,
which uploads them and (an int8 pool) quantizes them as they land. A
speculating decode server re-prefills the draft lane locally from the
prompt ids; the wire carries the target's K/V only.

Failure protocol (the retry seam `disagg/api.py` drives): a transport
death sets `failed` and parks the drain thread; the orchestrator drops
the dead peer (`receiver.next_peer()`), starts a fresh worker,
re-dispatches what is still undelivered, then `resume()`s the drain
thread onto the fresh connection. Payload delivery is atomic
(wire.py), so "undelivered" is exactly the set to re-request.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any

from defer_tpu_torch.disagg import wire
from defer_tpu_torch.obs.serving import DisaggMetrics
from defer_tpu_torch.runtime.batching import TimedQueue
from defer_tpu_torch.runtime.transport import ArrayReceiver, TransportError


class IngestError(RuntimeError):
    """A payload failed validation: a protocol or configuration skew,
    not a transient transport fault; retrying the worker won't fix it."""


class KVBlockIngest:
    """Drain one worker result stream into a PagedDecodeServer."""

    def __init__(
        self,
        server: Any,
        receiver: ArrayReceiver,
        *,
        obs: DisaggMetrics | None = None,
    ):
        self.server = server
        self.receiver = receiver
        self.obs = obs if obs is not None else DisaggMetrics("decode")
        self._queue = TimedQueue(self.obs.ingest_wait)
        self.delivered: set[int] = set()
        self.failed = threading.Event()
        self.error: BaseException | None = None
        self.eof = threading.Event()
        self._resume = threading.Event()
        self._closed = False
        self._thread: threading.Thread | None = None

    # -- drain thread -----------------------------------------------------

    def start(self) -> None:
        """Start the drain thread. It must run BEFORE the worker is
        dispatched: it performs the blocking accept the worker's result
        connection lands on."""
        self._thread = threading.Thread(
            target=self._drain_loop, name="kv-ingest", daemon=True
        )
        self._thread.start()

    # analysis: domain(drain) owns the blocking receive; payloads park in
    # _queue for the serving thread to pump
    def _drain_loop(self) -> None:
        while not self._closed:
            try:
                for payload in wire.iter_kv_payloads(
                    self.receiver, obs=self.obs
                ):
                    self._validate(payload)
                    self._queue.put(payload)
                self.eof.set()
                return
            except TransportError as e:
                # Event-mediated handoff: the error is written before
                # `failed` is set, and readers check `failed` first.
                self.error = e
                self.failed.set()
            except Exception as e:  # noqa: BLE001 (surfaced to the caller)
                self.error = e
                self.failed.set()
                return
            # Transport fault: park until the orchestrator has rewired
            # the session, then drain the fresh connection.
            self._resume.wait()
            self._resume.clear()

    def _validate(self, payload: wire.KVPayload) -> None:
        srv = self.server
        cfg = srv.dec.cfg
        entry = srv.pending_prefilled.get(payload.rid)
        if entry is None:
            raise IngestError(
                f"payload for unknown/already-admitted rid {payload.rid}"
            )
        t0 = entry["prompt"].shape[1]
        if payload.t0 != t0:
            raise IngestError(
                f"payload t0 {payload.t0} != submitted prompt length "
                f"{t0} for rid {payload.rid}"
            )
        expect = (
            cfg.num_layers,
            -(-t0 // srv.bs),
            cfg.kv_heads,
            srv.bs,
            cfg.dim // cfg.num_heads,
        )
        if tuple(payload.k.shape) != expect:
            raise IngestError(
                f"payload K shape {tuple(payload.k.shape)} != "
                f"{expect} — worker and server disagree on model "
                f"geometry or block_size"
            )

    # -- serving thread ---------------------------------------------------

    def pump(self) -> int:
        """Pop every parked payload and deliver it to the server (the
        serving thread only). Returns payloads delivered. Raises the
        drain thread's error when it was fatal (IngestError); transport
        faults are left for the orchestrator to read via `failed`."""
        n = 0
        while True:
            try:
                payload = self._queue.pop(timeout=0)
            except queue_mod.Empty:
                break
            self.server.deliver_kv(
                payload.rid, payload.k, payload.v, payload.logits
            )
            self.delivered.add(payload.rid)
            n += 1
        if self.failed.is_set() and isinstance(self.error, IngestError):
            raise self.error
        return n

    def undelivered(self) -> list[int]:
        """Rids submitted as prefilled but not yet handed to the server:
        the set a retry must re-request. Call after pump(): a parked
        payload is not delivered yet."""
        return [
            rid
            for rid in self.server._prefilled_order
            if rid not in self.delivered
        ]

    def resume(self) -> None:
        """Un-park the drain thread onto a rewired connection."""
        self.error = None
        self.failed.clear()
        self._resume.set()

    def close(self) -> None:
        self._closed = True
        self._resume.set()
