"""Host-side stream helpers (counterpart of `defer_tpu/runtime/host_io.py`):
the end-of-stream sentinel and the deadlock watchdog of the stream loop.
"""

from __future__ import annotations

import threading
import time

# End-of-stream sentinel a producer can put on the input queue (a None
# works too). The reference's feed loop blocks forever on `input_q.get()`
# (reference src/dispatcher.py:100) with no shutdown path at all.
STOP = object()


class ProgressMonitor:
    """Deadlock watchdog for the streaming loop.

    The reference hangs forever if a node dies mid-stream (single
    accepted peer, no timeout on the data path — reference
    src/node.py:102-103). Here: if no microbatch completes within
    `timeout_s` while work is outstanding, `check()` raises.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._last_progress = time.monotonic()
        self._outstanding = 0
        self._lock = threading.Lock()

    def submitted(self) -> None:
        with self._lock:
            if self._outstanding == 0:
                # Idle time (or first-compile time) before this submission
                # must not count against the watchdog.
                self._last_progress = time.monotonic()
            self._outstanding += 1

    def completed(self) -> None:
        with self._lock:
            self._outstanding -= 1
            self._last_progress = time.monotonic()

    def dropped(self, n: int) -> None:
        """Credit n submitted microbatches that were abandoned (elastic
        re-dispatch discards in-flight work) so the watchdog does not
        hold the recovered loop accountable for them forever."""
        with self._lock:
            self._outstanding -= n
            self._last_progress = time.monotonic()

    def check(self) -> None:
        with self._lock:
            stalled = (
                self._outstanding > 0
                and time.monotonic() - self._last_progress > self.timeout_s
            )
        if stalled:
            raise TimeoutError(
                f"pipeline made no progress for {self.timeout_s:.0f}s with "
                f"{self._outstanding} microbatch(es) outstanding — a stage "
                "or transfer is stuck"
            )
