"""Host spans and the trace seam over torch.profiler (counterpart of
`defer_tpu/utils/profiling.py`).

The stream path times each of its boundaries (`api.py` `_stream_loop`
and the `Retirer`'s barrier, `parallel/pipeline.py` `Pipeline.__call__`)
with one `time.perf_counter_ns()` pair. The pair always feeds a
float-seconds counter of the metrics registry (`obs/metrics.py`), and
while span recording is on it also becomes a span in `SPANS`, a bounded
in-memory buffer: name, start, end, host thread, parent span and the
microbatch's sequence id. Spans are named `defer:<boundary>`.

`trace(dir)` records the enclosed region with `torch.profiler` (CUDA
activity only: kernels, copies and the runtime's calls; the host's ops
where there is no card), turns span recording on for its duration, and
writes one Chrome trace in which the spans sit as complete events on
their thread's row, on the profiler's clock. `annotate(name)` is a span
around a block: one flag check while recording is off.

Both degrade to no-ops when profiling is unavailable, so production
paths can call them unconditionally.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Set to a directory to capture a trace of the stream loop.
TRACE_ENV = "DEFER_TPU_TRACE"
# Spans kept while recording; the oldest go first past it.
SPAN_CAPACITY = 1 << 16

clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int  # perf_counter_ns
    end_ns: int
    thread: int  # native thread id (its row in a trace: `_rows`)
    span_id: int
    parent: int  # 0: a root
    seq: int  # the microbatch's sequence id; -1: none


class _Open(NamedTuple):
    name: str
    start_ns: int
    span_id: int
    parent: int
    seq: int


class SpanRecorder:
    """Host spans in a bounded buffer, and each thread's open ones.

    `on` is the one flag a boundary checks. Spans nest per thread: a
    span recorded while another is open on the same thread takes that
    one's id as its parent and its sequence id. `open` / `close` bracket
    a span that has children; `record` keeps a span (and its leaf
    children) whose clock reads the caller already took. One recording
    at a time: `start` turns recording on, `stop` turns it off and
    hands the buffer over, emptied."""

    def __init__(self):
        self.on = False
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=SPAN_CAPACITY
        )
        self._ids = itertools.count(1)
        self._local = threading.local()

    def start(self) -> None:
        self._spans.clear()
        self.on = True

    def stop(self) -> list[Span]:
        self.on = False
        spans = list(self._spans)
        self._spans.clear()
        return spans

    def _thread(self):
        """This thread's open spans, native id and last sequence id."""
        t = self._local
        if not hasattr(t, "stack"):
            t.stack, t.tid, t.seq = [], threading.get_native_id(), -1
        return t

    def open(self, name: str, start_ns: int, seq: int | None = None) -> _Open:
        """Open a span on this thread; `seq` starts a microbatch's
        spans (later spans on the thread default to it)."""
        t = self._thread()
        parent = t.stack[-1] if t.stack else None
        if seq is not None:
            t.seq = seq
        elif parent is not None:
            seq = parent.seq
        else:
            seq = t.seq
        span = _Open(name, start_ns, next(self._ids),
                     parent.span_id if parent is not None else 0, seq)
        t.stack.append(span)
        return span

    def close(self, span: _Open, end_ns: int) -> None:
        t = self._thread()
        if t.stack and t.stack[-1] is span:
            t.stack.pop()
        self._spans.append(Span(span.name, span.start_ns, end_ns, t.tid,
                                span.span_id, span.parent, span.seq))

    def record(self, name: str, start_ns: int, end_ns: int,
               children: tuple = (), seq: int | None = None) -> None:
        """Keep a finished span, and `children`, (name, start_ns,
        end_ns) leaves under it."""
        span = self.open(name, start_ns, seq)
        self.close(span, end_ns)
        tid = self._local.tid
        for child, a, b in children:
            self._spans.append(Span(child, a, b, tid, next(self._ids),
                                    span.span_id, span.seq))


# The process's spans: the hot path reads `SPANS.on`.
SPANS = SpanRecorder()


class _Annotation:
    __slots__ = ("name", "seq", "_span")

    def __init__(self, name: str, seq: int | None):
        self.name, self.seq = name, seq

    def __enter__(self):
        self._span = SPANS.open(self.name, clock(), self.seq)

    def __exit__(self, *exc):
        SPANS.close(self._span, clock())


_NOOP = contextlib.nullcontext()


def annotate(name: str, seq: int | None = None):
    """A span around the block while recording is on (`seq` marks the
    root of a microbatch's spans); a shared no-op context otherwise."""
    if not SPANS.on:
        return _NOOP
    return _Annotation(name, seq)


CUDA_CALLS = ("cuda_runtime", "cuda_driver")  # the trace's host-side CUDA rows


def _rows(events: list, spans: list[dict]) -> dict[int, int]:
    """Each recording thread's row in the profiler's trace. Where the
    profiler recorded the thread's ops (CPU activity) the row is its
    native id. Where it recorded CUDA calls alone, it files them under
    CUPTI's id for the thread, which nothing in Python gives: the row
    is the one whose calls fall inside the thread's spans most often."""
    seen = {e.get("tid") for e in events if e.get("cat") not in CUDA_CALLS}
    calls = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in CUDA_CALLS and e.get("ph") == "X":
            calls[e["tid"]].append(e["ts"])
    for ts in calls.values():
        ts.sort()
    rows = {}
    for native in {s["tid"] for s in spans}:
        rows[native] = native
        if native in seen:
            continue
        union: list[list[float]] = []
        for s in sorted((s for s in spans if s["tid"] == native),
                        key=lambda s: s["ts"]):
            if union and s["ts"] <= union[-1][1]:
                union[-1][1] = max(union[-1][1], s["ts"] + s["dur"])
            else:
                union.append([s["ts"], s["ts"] + s["dur"]])
        inside = {
            row: sum(bisect.bisect_right(ts, b) - bisect.bisect_left(ts, a)
                     for a, b in union)
            for row, ts in calls.items()
        }
        best = max(inside, key=inside.get, default=None)
        if best is not None and inside[best]:
            rows[native] = best
    return rows


def merge_spans(path: str, spans: list[Span], offset_ns: int) -> None:
    """Add `spans` to the Chrome trace at `path` as complete events on
    their thread's row (`_rows`). `offset_ns` takes perf_counter_ns to
    the profiler's clock (the realtime clock); the trace's `ts` is that
    in us past its `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    added = [
        {
            "ph": "X", "cat": "defer", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns + offset_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span": s.span_id, "parent": s.parent,
                     "microbatch": s.seq},
        }
        for s in spans
    ]
    rows = _rows([e for e in doc["traceEvents"] if e.get("pid") == pid], added)
    for e in added:
        e["tid"] = rows[e["tid"]]
    doc["traceEvents"].extend(added)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """Profile the block into `trace_dir` (or $DEFER_TPU_TRACE) as
    `trace_<pid>.json`, the program's spans merged in; no-op if neither
    is set or the profiler fails to start."""
    target = trace_dir or os.environ.get(TRACE_ENV)
    if not target:
        yield None
        return
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CUDA if torch.cuda.is_available() else act.CPU]
    )
    try:
        prof.__enter__()
    except Exception as e:  # profiler can be unsupported per-platform
        log.warning("profiler trace unavailable: %s", e)
        yield None
        return
    offset_ns = time.time_ns() - time.perf_counter_ns()
    SPANS.start()
    try:
        yield target
    finally:
        spans = SPANS.stop()
        try:
            prof.__exit__(None, None, None)
            os.makedirs(target, exist_ok=True)
            path = os.path.join(target, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            merge_spans(path, spans, offset_ns)
            log.info("wrote trace to %s", path)
        except Exception as e:
            log.warning("profiler stop failed: %s", e)


class WindowTrace:
    """Trace a bounded window of an unbounded loop.

    An open-ended `trace()` around a serving loop would buffer events
    for the whole process lifetime. This starts on the first `tick()`
    and stops after `limit` ticks — or at `close()`, whichever comes
    first. Inert unless $DEFER_TPU_TRACE (or trace_dir) is set.
    """

    def __init__(self, limit: int = 64, trace_dir: str | None = None):
        self.limit = limit
        self.target = trace_dir or os.environ.get(TRACE_ENV)
        self._ticks = 0
        self._cm = None  # the trace() context, entered on first tick
        self._active = False
        self._done = False

    def tick(self) -> None:
        if not self.target or self._done:
            return
        if not self._active:
            self._cm = trace(self.target)
            if self._cm.__enter__() is None:  # profiler unavailable
                self._cm.__exit__(None, None, None)
                self._done = True
                return
            self._active = True
        self._ticks += 1
        if self._ticks >= self.limit:
            self.close()

    def close(self) -> None:
        if self._active:
            self._cm.__exit__(None, None, None)
            self._active = False
        self._done = True
