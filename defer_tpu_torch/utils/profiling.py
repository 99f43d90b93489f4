"""Tracing seam over torch.profiler (counterpart of
`defer_tpu/utils/profiling.py`).

`trace(dir)` captures a profile of the enclosed region and writes it as
a Chrome trace; `annotate(name)` labels host regions (stage dispatch,
feed, drain) so pipeline bubbles show against device activity — as a
`record_function` range in the profiler and an NVTX range on the card.

Both degrade to no-ops when profiling is unavailable, so production
paths can call them unconditionally.
"""

from __future__ import annotations

import contextlib
import os

import torch

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Set to a directory to capture a trace of the stream loop.
TRACE_ENV = "DEFER_TPU_TRACE"


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """Profile the block into `trace_dir` (or $DEFER_TPU_TRACE) as
    `trace_<pid>.json`; no-op if neither is set or the profiler fails to
    start."""
    target = trace_dir or os.environ.get(TRACE_ENV)
    if not target:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:  # profiler can be unsupported per-platform
        log.warning("profiler trace unavailable: %s", e)
        yield None
        return
    try:
        yield target
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(target, exist_ok=True)
            path = os.path.join(target, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            log.info("wrote trace to %s", path)
        except Exception as e:
            log.warning("profiler stop failed: %s", e)


@contextlib.contextmanager
def annotate(name: str):
    """Named host-region annotation visible in captured traces (and as
    an NVTX range on a CUDA build)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
