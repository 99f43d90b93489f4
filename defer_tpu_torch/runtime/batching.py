"""Dynamic batching for the streaming serve path (counterpart of
`BatchGatherer`, `Deadline`, `split_output`, `window_drain_order` and
`accept_lengths` in `defer_tpu/runtime/batching.py`).

Coalesces adjacent queue items into one device batch under a latency
SLO, and splits the batched output back into per-item results, so the
item-in/item-out queue contract survives while the card sees real
batches. Enable via DeferConfig(dynamic_batch_size=N, batch_wait_s=SLO).

Unlike the JAX package, a partial batch is not padded up to a
power-of-two bucket: eager PyTorch compiles nothing per batch shape, so
padding would only add work.
"""

from __future__ import annotations

import math
import queue as queue_mod
import time
from typing import Any

import numpy as np
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

    def expired(self) -> bool:
        return self.remaining() <= 0

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


class TimedQueue:
    """Thread-safe FIFO that times each item from put() to pop() into a
    caller-supplied histogram: how long produced work sat waiting for
    its consumer. The disagg ingest path surfaces
    `defer_kv_ingest_wait_seconds` through it (disagg/ingest.py)."""

    def __init__(self, histogram=None):
        self._q: "queue_mod.Queue[tuple[float, Any]]" = queue_mod.Queue()
        self._hist = histogram

    def put(self, item: Any) -> None:
        self._q.put((time.monotonic(), item))

    def pop(self, timeout: float | None = None) -> Any:
        """Blocking get; raises queue.Empty on timeout like Queue.get."""
        t_in, item = self._q.get(timeout=timeout)
        if self._hist is not None:
            self._hist.observe(time.monotonic() - t_in)
        return item


def window_drain_order(valid_lens, width: int):
    """Tick-major order for draining a decode window's [B, K] token
    buffer with per-slot valid lengths: yields (t, i) for every accepted
    token, sub-step first and slot second, so streaming callbacks fire
    in the interleaving a decode_window=1 loop produces."""
    for t in range(width):
        for i, n in enumerate(valid_lens):
            if t < n:
                yield t, i


def accept_lengths(props, preds):
    """Greedy speculative accept test, batched: per row, the index of
    the first draft token that disagrees with the target's argmax at
    the same position, or k when the whole proposal matches. `props`
    [B, k] proposals, `preds` [B, k] the target's argmax at the k
    proposal positions; both on the host (numpy or lists). Returns [B]
    int64."""
    props = np.asarray(props)
    preds = np.asarray(preds)
    if props.shape != preds.shape or props.ndim != 2:
        raise ValueError(
            f"props/preds must be matching [B, k], got "
            f"{props.shape}/{preds.shape}"
        )
    mismatch = props != preds
    first_bad = mismatch.argmax(axis=1)
    return np.where(mismatch.any(axis=1), first_bad, props.shape[1])


def microbatch_groups(max_batch: int, num_groups: int) -> list[list[int]]:
    """Partition the slot indices [0, max_batch) into `num_groups`
    contiguous microbatch groups for pipelined decode (runtime/paged.py
    pp_stages=). Groups tile the batch evenly: every group rides the
    same stage programs, one shape for all of them."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    if max_batch % num_groups:
        raise ValueError(
            f"max_batch {max_batch} must divide evenly into "
            f"{num_groups} microbatch groups — pick max_batch a "
            f"multiple of the in-flight count (pp_inflight)"
        )
    g = max_batch // num_groups
    return [list(range(k * g, (k + 1) * g)) for k in range(num_groups)]


def pp_schedule_occupancy(
    busy_slots: list[int], total_slots: int
) -> tuple[list[float], float]:
    """Per-stage occupancy and bubble fraction of one realized pipelined
    decode window, from dispatch-slot accounting: `busy_slots[s]` =
    stage-step dispatches stage s issued, `total_slots` = schedule slots
    spanned from the first stage-0 dispatch to the last final-stage
    dispatch. In the full GPipe schedule (M groups x W rounds, no early
    freezes) this is the closed-form bubble (S-1)/(S-1+M*W); groups that
    are idle at the window boundary lower it. Schedule slots are logical
    dispatch positions, so the numbers do not depend on placement."""
    if total_slots <= 0:
        return [0.0] * len(busy_slots), 0.0
    occ = [min(b / total_slots, 1.0) for b in busy_slots]
    mean = sum(occ) / len(occ) if occ else 0.0
    return occ, 1.0 - mean


def _nest(vals: list, shape: tuple):
    """A flat list as the nested lists `.tolist()` of `shape` gives."""
    if len(shape) <= 1:
        return vals if shape else vals[0]
    n = math.prod(shape[1:])
    return [_nest(vals[i * n:(i + 1) * n], shape[1:])
            for i in range(shape[0])]


def host_lists(tensors: list) -> list:
    """Small int and bool device tensors as the host lists `.tolist()`
    gives each, in ONE device-to-host transfer (one sync, where a
    `.tolist()` each would sync once each); none for no tensors."""
    if not tensors:
        return []
    if len(tensors) == 1:
        # analysis: ignore[host-sync-in-hot-loop] this IS the tick's one
        # batched transfer, here of one tensor: no copy before it
        return [tensors[0].tolist()]
    # Cast only where the dtypes differ (the one concatenation needs one).
    same = all(t.dtype == tensors[0].dtype for t in tensors)
    # analysis: ignore[host-sync-in-hot-loop] this IS the tick's one batched
    # transfer: every caller folds its host reads into it
    flat = torch.cat([t.reshape(-1) if same else t.reshape(-1).long()
                      for t in tensors]).tolist()
    out, at = [], 0
    for t in tensors:
        vals = flat[at:at + t.numel()]
        at += t.numel()
        if t.dtype == torch.bool:
            vals = [bool(v) for v in vals]
        out.append(_nest(vals, tuple(t.shape)))
    return out
