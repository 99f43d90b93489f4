"""Admission control for the fleet front-end: bounded per-replica
queues plus SLO-driven load shedding. Counterpart of
`defer_tpu/fleet/admission.py`.

The failure mode this file exists for: under overload an UNBOUNDED
queue converts excess arrival rate into unbounded queue wait — every
request eventually completes, and every request's latency is ruined.
Admission control inverts that: the queue depth is bounded, the
enqueue wait is deadline-bounded (`runtime/batching.py::Deadline`, the
same monotonic remaining-budget machinery the batch gatherer's flush
SLO runs on), and once the ROLLING queue-wait p99 exceeds the
configured SLO new arrivals are rejected with a typed `ShedError`
instead of being queued into certain SLO violation. Shedding keeps the
p99 of the traffic that IS admitted bounded — overload degrades into
explicit rejections, not collapsed tail latency.

The p99 estimate is a rolling window (a deque of the most recent
waits), NOT the cumulative obs histogram: a cumulative estimate can
never recover after a burst (old samples are never forgotten), so the
shedder would latch open. The obs histogram still records every wait
for dashboards; only the shedding DECISION reads the window.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any

from defer_tpu_torch.runtime.batching import Deadline


class ShedError(Exception):
    """Typed admission rejection. `reason` is one of
    FleetMetrics.SHED_REASONS: "queue_full" (the bounded queue never
    drained within the enqueue deadline) or "slo" (the rolling
    queue-wait p99 already exceeds the SLO — queueing more work would
    only deepen the violation)."""

    def __init__(
        self,
        reason: str,
        replica: int,
        *,
        queue_depth: int = 0,
        wait_p99_s: float | None = None,
        slo_s: float | None = None,
    ):
        self.reason = reason
        self.replica = replica
        self.queue_depth = queue_depth
        self.wait_p99_s = wait_p99_s
        self.slo_s = slo_s
        detail = f"queue_depth={queue_depth}"
        if wait_p99_s is not None:
            detail += f", queue-wait p99 {wait_p99_s * 1e3:.1f}ms"
        if slo_s is not None:
            detail += f" vs SLO {slo_s * 1e3:.1f}ms"
        super().__init__(
            f"request shed ({reason}) at replica {replica}: {detail}"
        )


class AdmissionController:
    """Bounded FIFO admission queue per replica.

    Producer side (`admit`, router thread): sheds on SLO violation,
    then blocks for queue space under a `Deadline` and sheds on
    expiry. Consumer side (`try_pop`/`pop`, each replica's serving
    thread): records the realized queue wait into both the obs
    histogram and the rolling shedding window.

    `max_queue=0` means unbounded (and `queue_full` unreachable);
    `slo_s=None` disables SLO shedding. Both defaults keep
    `serve_fleet` shed-free so the single-replica token-identity
    contract needs no carve-outs."""

    def __init__(
        self,
        n_replicas: int,
        obs: Any,
        *,
        max_queue: int = 0,
        slo_s: float | None = None,
        enqueue_wait_s: float = 0.05,
        window: int = 512,
    ):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.obs = obs
        self.max_queue = max_queue
        self.slo_s = slo_s
        self.enqueue_wait_s = enqueue_wait_s
        self._queues: list["queue_mod.Queue[tuple[float, Any]]"] = [
            queue_mod.Queue(maxsize=max_queue) for _ in range(n_replicas)
        ]
        self._waits: list[deque] = [
            deque(maxlen=window) for _ in range(n_replicas)
        ]
        self._wait_locks = [threading.Lock() for _ in range(n_replicas)]

    def wait_p99(self, idx: int) -> float:
        """Rolling p99 of the most recent realized queue waits for one
        replica (0.0 while the window is empty)."""
        with self._wait_locks[idx]:
            waits = sorted(self._waits[idx])
        if not waits:
            return 0.0
        return waits[min(int(0.99 * len(waits)), len(waits) - 1)]

    def depth(self, idx: int) -> int:
        return self._queues[idx].qsize()

    def admit(self, idx: int, item: Any) -> None:
        """Enqueue `item` for replica `idx` or raise ShedError. The
        enqueue timestamp rides the queue entry so the consumer's
        pickup measures the full queued interval."""
        if self.slo_s is not None:
            p99 = self.wait_p99(idx)
            if p99 > self.slo_s:
                self.obs.shed["slo"].inc()
                raise ShedError(
                    "slo",
                    idx,
                    queue_depth=self.depth(idx),
                    wait_p99_s=p99,
                    slo_s=self.slo_s,
                )
        q = self._queues[idx]
        if self.max_queue == 0:
            q.put((time.monotonic(), item))
        else:
            dl = Deadline(self.enqueue_wait_s)
            while True:
                try:
                    q.put(
                        (time.monotonic(), item),
                        timeout=max(dl.remaining(), 1e-4),
                    )
                    break
                except queue_mod.Full:
                    if dl.expired():
                        self.obs.shed["queue_full"].inc()
                        raise ShedError(
                            "queue_full",
                            idx,
                            queue_depth=self.depth(idx),
                            wait_p99_s=self.wait_p99(idx) or None,
                            slo_s=self.slo_s,
                        ) from None
        self.obs.queue_depth[idx].set(q.qsize())

    def try_pop(self, idx: int, timeout: float | None = None) -> Any:
        """Consumer pickup: the queued item, or None when empty after
        `timeout` (None = non-blocking). Records the realized wait."""
        q = self._queues[idx]
        try:
            if timeout is None:
                t_enq, item = q.get_nowait()
            else:
                t_enq, item = q.get(timeout=timeout)
        except queue_mod.Empty:
            return None
        wait = time.monotonic() - t_enq
        self.obs.queue_wait[idx].observe(wait)
        with self._wait_locks[idx]:
            self._waits[idx].append(wait)
        self.obs.queue_depth[idx].set(q.qsize())
        return item

    def drain(self, idx: int) -> list[Any]:
        """Empty replica `idx`'s queue (replica-death requeue path):
        returns the queued items, oldest first, without recording
        waits — these requests were never picked up."""
        out = []
        q = self._queues[idx]
        while True:
            try:
                out.append(q.get_nowait()[1])
            except queue_mod.Empty:
                break
        self.obs.queue_depth[idx].set(0)
        return out

    def record_wait(self, idx: int, wait_s: float) -> None:
        """Seed the rolling window directly (tests drive the SLO
        shedder without a real queue backlog)."""
        self.obs.queue_wait[idx].observe(wait_s)
        with self._wait_locks[idx]:
            self._waits[idx].append(wait_s)
