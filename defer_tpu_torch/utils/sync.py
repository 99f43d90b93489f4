"""Device completion: events, barriers and the windowed retire.

The counterpart of `defer_tpu/utils/sync.py`. PyTorch returns from a
CUDA call once the work is enqueued, so a result is a future. The
completion marker is a `torch.cuda.Event` recorded on the producing
stream right after the last stage was enqueued (`Pending`): `is_ready()`
is `event.query()`, the barrier is `event.synchronize()`. On the CPU the
work is done when the call returns, so a CPU result is always ready.

Design consequence for hot loops (see Pipeline.stream): never wait
per-item; sync once per window on one result, and retire the whole
prefix — stream order guarantees everything enqueued before the synced
item has also completed.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Iterator

import torch

# How long hard_sync_timeout sleeps between two polls of an event.
_POLL_S = 0.0005


def _leaves(values: Any) -> Iterator[Any]:
    if isinstance(values, (tuple, list)):
        for v in values:
            yield from _leaves(v)
    elif isinstance(values, dict):
        for v in values.values():
            yield from _leaves(v)
    else:
        yield values


def _cuda_device(value: Any) -> torch.device | None:
    for leaf in _leaves(value):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


class Pending:
    """A result whose work is enqueued, with the event recorded right
    after it on its device's current stream (None when the result lies
    on the CPU: it is complete already)."""

    __slots__ = ("value", "event")

    def __init__(self, value: Any):
        self.value = value
        dev = _cuda_device(value)
        self.event = None
        if dev is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            # analysis: ignore[host-sync-in-hot-loop] this IS the sanctioned
            # barrier (Retirer / hard_sync): callers reach it once a window of
            # microbatches, not an item
            self.event.synchronize()


def hard_sync(*values: Any) -> None:
    """Block until every given value's computation has completed.
    A `Pending` waits on its event; a bare CUDA tensor waits on its
    device's current stream (where the port enqueues all its work).
    Accepts nested tuples — multi-tensor pipeline boundaries."""
    for leaf in _leaves(values):
        if isinstance(leaf, Pending):
            leaf.wait()
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            # analysis: ignore[host-sync-in-hot-loop] same: the explicit
            # barrier callers ask for
            torch.cuda.current_stream(leaf.device).synchronize()


def hard_sync_timeout(value: Any, timeout_s: float) -> bool:
    """hard_sync with a deadline: polls `is_ready()` (a `Pending`'s
    event query; other values are wrapped in one) until it completes
    (True) or the deadline passes (False) — the caller decides how to
    fail. A CUDA error that surfaces on the query is raised, not
    swallowed. Used by the streaming drain so a stuck stage trips the
    watchdog instead of hanging the host forever."""
    if not hasattr(value, "is_ready"):
        value = Pending(value)
    deadline = time.monotonic() + timeout_s
    while not value.is_ready():
        if time.monotonic() >= deadline:
            return False
        time.sleep(_POLL_S)
    return True


class Retirer:
    """Windowed retire of async results, in order.

    The one implementation of the batched-barrier pattern every hot loop
    here uses (Pipeline.stream, DEFER.run_defer): emit the known-ready
    prefix for free; under depth pressure take ONE barrier on the middle
    of the window and retire the whole prefix — stream order guarantees
    everything enqueued before the synced item has completed. Never wait
    per-item. Items are anything with `is_ready()` (a `Pending`).

    `sync` is the barrier (default `hard_sync`); a caller may supply a
    timeout-aware one (DEFER's watchdog barrier). It must not mutate the
    queue — retirement is identity-based on the synced item, so a
    barrier that covers more (or fewer) items than the caller guessed
    still retires exactly the completed prefix.
    """

    def __init__(
        self,
        depth: int,
        sync: Callable[[Any], None] = hard_sync,
    ):
        self.depth = depth
        self.sync = sync
        self.pending: collections.deque[Any] = collections.deque()
        # Completed results rescued when a barrier raised mid-add —
        # returned by the next collect() instead of being lost.
        self._spill: list[Any] = []

    def __len__(self) -> int:
        return len(self.pending)

    def ready_count(self) -> int:
        """Length of the known-completed prefix (including any
        barrier-failure spill)."""
        n = len(self._spill)
        for item in self.pending:
            if not item.is_ready():
                break
            n += 1
        return n

    def _pop_through(self, target: Any) -> list[Any]:
        out = []
        while self.pending:
            done = self.pending[0] is target
            out.append(self.pending.popleft())
            if done:
                break
        return out

    def add(self, item: Any) -> list[Any]:
        """Enqueue one async result; returns items retired by pressure
        (ready prefix plus, at depth, one batched-barrier prefix)."""
        self.pending.append(item)
        out = self.collect()
        if len(self.pending) >= self.depth:
            target = self.pending[len(self.pending) // 2]
            try:
                self.sync(target)
            except BaseException:
                # The already-collected prefix is COMPLETED work; park
                # it so a recovering caller's next collect() emits it
                # rather than losing it with the raise.
                self._spill = out + self._spill
                raise
            out.extend(self._pop_through(target))
        return out

    def collect(self) -> list[Any]:
        """Retire the known-ready prefix (plus any barrier-failure
        spill) without blocking."""
        out = self._spill
        self._spill = []
        while self.pending and self.pending[0].is_ready():
            out.append(self.pending.popleft())
        return out

    def flush(self) -> list[Any]:
        """Barrier on the newest item and retire everything."""
        if self.pending:
            self.sync(self.pending[-1])
        out = self._spill + list(self.pending)
        self._spill = []
        self.pending.clear()
        return out

    def discard(self) -> int:
        """Drop every pending item WITHOUT syncing; returns the count.

        For failure recovery: in-flight results of a dead pipeline can
        neither complete nor be waited on — the caller re-dispatches
        and accepts the loss."""
        n = len(self.pending)
        self.pending.clear()
        return n
