"""Dynamic batching for the streaming serve path (counterpart of
`BatchGatherer`, `Deadline` and `split_output` in
`defer_tpu/runtime/batching.py`).

Coalesces adjacent queue items into one device batch under a latency
SLO, and splits the batched output back into per-item results, so the
item-in/item-out queue contract survives while the card sees real
batches. Enable via DeferConfig(dynamic_batch_size=N, batch_wait_s=SLO).

Unlike the JAX package, a partial batch is not padded up to a
power-of-two bucket: eager PyTorch compiles nothing per batch shape, so
padding would only add work.
"""

from __future__ import annotations

import queue as queue_mod
import time
from typing import Any

import torch

from defer_tpu_torch.obs.metrics import get_registry
from defer_tpu_torch.runtime.host_io import STOP

# Leading-dim buckets 1..1024 (powers of two) for batch occupancy.
_ROW_BUCKETS = tuple(float(1 << i) for i in range(11))


class Deadline:
    """Monotonic SLO deadline: one start-time capture plus
    remaining-budget arithmetic, for wait loops that block "at most X
    seconds after the first event"."""

    __slots__ = ("t0", "at")

    def __init__(self, budget_s: float):
        self.t0 = time.monotonic()
        self.at = self.t0 + budget_s

    def remaining(self) -> float:
        """Seconds of budget left (negative once expired)."""
        return self.at - time.monotonic()

    def elapsed(self) -> float:
        """Seconds since the deadline was armed."""
        return time.monotonic() - self.t0


class BatchGatherer:
    """Coalesce queue items (tensors or arrays with a leading batch dim)
    into one stacked batch per dispatch.

    Items with mismatched trailing shapes or dtypes are never mixed: a
    mismatch flushes the current batch and the odd item starts the
    next one (carried between calls).
    """

    def __init__(self, batch_size: int, max_wait_s: float):
        if batch_size < 2:
            raise ValueError("dynamic batching needs batch_size >= 2")
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self._carry: Any = None
        # Metric handles resolved once; gather() then pays one histogram
        # observe + counter inc per FLUSH, nothing per item.
        reg = get_registry()
        self._obs_rows = reg.histogram(
            "defer_batch_rows",
            "Device-batch occupancy (rows) per dispatch",
            _ROW_BUCKETS,
        )
        self._obs_wait = reg.histogram(
            "defer_batch_wait_seconds",
            "First item to flush (bounded by the batch_wait_s SLO)",
        )
        self._obs_flush = {
            reason: reg.counter(
                "defer_batch_flush_total",
                "Batches flushed, by why gathering stopped",
                {"reason": reason},
            )
            for reason in ("full", "timeout", "eos", "mismatch")
        }

    @staticmethod
    def _compatible(a: Any, b: Any) -> bool:
        return (
            getattr(a, "ndim", 0) >= 1
            and getattr(b, "ndim", 0) >= 1
            and a.shape[1:] == b.shape[1:]
            and a.dtype == b.dtype
        )

    def gather(
        self, input_stream: "queue_mod.Queue[Any]", poll_s: float = 0.05
    ) -> tuple[Any, list[int] | None, bool]:
        """Pull one batch. Returns (batch, sizes, eos):

        * batch: stacked tensor (or None if only the sentinel / nothing
          arrived); sizes: per-item leading-dim sizes for the splitter.
        * eos: the STOP/None sentinel was consumed.

        Blocks at most `poll_s` for the FIRST item (so the caller's
        idle loop keeps servicing results), then at most `max_wait_s`
        total for the rest of the batch.
        """
        items: list[Any] = []
        if self._carry is not None:
            items.append(self._carry)
            self._carry = None
        eos = False
        if not items:
            try:
                first = input_stream.get(timeout=poll_s)
            except queue_mod.Empty:
                return None, None, False
            if first is None or first is STOP:
                return None, None, True
            items.append(first)
        if getattr(items[0], "ndim", 0) < 1:
            raise ValueError(
                "dynamic batching requires queue items with a leading "
                f"batch dim; got shape {getattr(items[0], 'shape', ())} — "
                "disable dynamic_batch_size or add a batch axis"
            )
        # batch_size bounds ROWS (the device batch), not item count. An
        # item that would overflow the bound is carried to the next
        # batch (unless a single item is itself larger — items are
        # atomic).
        total = int(items[0].shape[0])
        dl = Deadline(self.max_wait_s)
        reason = "full"  # loop exits via its condition when filled
        while total < self.batch_size:
            remaining = dl.remaining()
            if remaining <= 0:
                reason = "timeout"
                break
            try:
                nxt = input_stream.get(timeout=remaining)
            except queue_mod.Empty:
                reason = "timeout"
                break
            if nxt is None or nxt is STOP:
                eos = True
                reason = "eos"
                break
            if (
                not self._compatible(items[0], nxt)
                or total + int(nxt.shape[0]) > self.batch_size
            ):
                # Flush what we have; the odd item opens the next batch.
                self._carry = nxt
                reason = "mismatch"
                break
            items.append(nxt)
            total += int(nxt.shape[0])
        self._obs_rows.observe(float(total))
        self._obs_wait.observe(dl.elapsed())
        self._obs_flush[reason].inc()
        sizes = [int(x.shape[0]) for x in items]
        tensors = [torch.as_tensor(x) for x in items]
        batch = tensors[0] if len(tensors) == 1 else torch.cat(tensors, 0)
        return batch, sizes, eos


def split_output(out: Any, sizes: list[int]) -> list[Any]:
    """Invert the gather: slice the batched output back into per-item
    results (device-side views; no host transfer)."""
    if len(sizes) == 1:
        return [out]
    parts = []
    off = 0
    for s in sizes:
        parts.append(out[off : off + s])
        off += s
    return parts
