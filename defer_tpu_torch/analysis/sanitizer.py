"""Runtime half: prove a block captures nothing new and syncs no more
than it should.

The static rules catch the *patterns*; these two guards catch the
facts, in the role the reference's ``trace_sanitizer`` plays for jit
retraces.

``capture_sanitizer(*targets, allow=0)`` snapshots every
``graph_captures`` counter and every captured-graph dict (``_graphs``)
it finds on its targets, runs the block, and raises ``RecaptureError``
if anything was captured inside it: a warmed serving loop replays its
CUDA graphs and never captures again.

    srv = PagedDecodeServer(..., decode_window=4)
    ...admit + warm-up windows...
    with capture_sanitizer(srv) as rep:
        for _ in range(3):
            srv.step()
    # raises if a window key was captured inside the block

Targets may be any object: the object itself and its attributes (one
level, values of dict attributes included, as the reference scans) are
watched when they carry ``graph_captures`` or ``_graphs`` (the paged
server, the flat ``DecodeServer``, a fleet replica's server). One
object counts once: the larger of its counter's growth and its graph
dict's.

``sync_sanitizer(allow=n)`` counts the synchronizing CUDA calls the
block makes (``torch.cuda.set_sync_debug_mode("warn")``, whose warnings
it catches) and raises ``HostSyncError`` above ``n``; it restores the
previous mode on exit, errors included. Without a CUDA device, or given
a CPU device, it counts nothing and says so in its report.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Iterator

import torch


class RecaptureError(AssertionError):
    """A watched server captured a CUDA graph inside a sanitized block.
    Subclasses AssertionError so pytest reports it as a plain test
    failure, not an error."""


class HostSyncError(AssertionError):
    """A sanitized block made more synchronizing CUDA calls than it
    allows."""


def _capturer(obj: Any) -> bool:
    return isinstance(getattr(obj, "graph_captures", None), int) or (
        isinstance(getattr(obj, "_graphs", None), dict))


def _scan(targets: tuple[Any, ...]) -> dict[str, Any]:
    found: dict[str, Any] = {}

    def add(label: str, obj: Any) -> None:
        if _capturer(obj) and not any(obj is o for o in found.values()):
            found.setdefault(label, obj)

    for t in targets:
        tname = type(t).__name__
        add(tname, t)
        for k, v in list(getattr(t, "__dict__", {}).items()):
            add(f"{tname}.{k}", v)
            if isinstance(v, dict):
                for kk, vv in list(v.items()):
                    add(f"{tname}.{k}[{kk!r}]", vv)
    return found


def _state(obj: Any) -> tuple[int, frozenset]:
    graphs = getattr(obj, "_graphs", None)
    return (getattr(obj, "graph_captures", 0) or 0,
            frozenset(graphs) if isinstance(graphs, dict) else frozenset())


class CaptureReport:
    """Filled in at block exit: what was watched, what was captured
    (the count by object, and the new graph keys)."""

    def __init__(self) -> None:
        self.watched: list[str] = []
        self.deltas: dict[str, int] = {}
        self.new_keys: dict[str, list] = {}

    @property
    def captures(self) -> int:
        return sum(self.deltas.values())


@contextlib.contextmanager
def capture_sanitizer(*targets: Any, allow: int = 0
                      ) -> Iterator[CaptureReport]:
    """Fail the block if the watched objects capture more than `allow`
    CUDA graphs in total. Raises ValueError when no target carries a
    capture counter or a graph dict — a sanitizer watching nothing
    proves nothing."""
    objs = _scan(targets)
    if not objs:
        raise ValueError(
            "capture_sanitizer found no graph_captures counter or _graphs "
            "dict on its targets — pass a server (or what holds one)"
        )
    report = CaptureReport()
    report.watched = list(objs)
    before = {label: _state(obj) for label, obj in objs.items()}
    try:
        yield report
    finally:
        for label, obj in objs.items():
            n0, keys0 = before[label]
            n1, keys1 = _state(obj)
            new = keys1 - keys0
            delta = max(n1 - n0, len(new))
            if delta > 0:
                report.deltas[label] = delta
                report.new_keys[label] = sorted(map(repr, new))
    if report.captures > allow:
        detail = ", ".join(
            f"{label}: +{n} {report.new_keys[label]}"
            for label, n in sorted(report.deltas.items())
        )
        raise RecaptureError(
            f"{report.captures} capture(s) inside sanitized block "
            f"(allow={allow}): {detail} — a warmed serving loop replays; "
            "capture each window key in warm-up"
        )


class SyncReport:
    """Filled in at block exit: whether counting was on, the count, and
    each synchronizing call's warning text."""

    def __init__(self) -> None:
        self.active = False
        self.note = ""
        self.messages: list[str] = []

    @property
    def syncs(self) -> int:
        return len(self.messages)


_SYNC_WARNING = "synchronizing CUDA operation"


@contextlib.contextmanager
def sync_sanitizer(allow: int = 0) -> Iterator[SyncReport]:
    """Fail the block if it makes more than `allow` synchronizing CUDA
    calls (a `.item()`, a `.tolist()`, a device-to-host copy that is not
    non_blocking into pinned memory, a stream or device synchronize).
    A no-op, which its report says, without a CUDA device: nothing
    synchronizes a card there. With a card it always counts."""
    report = SyncReport()
    if not torch.cuda.is_available():
        report.note = ("no CUDA device: nothing to count (a CPU tensor "
                       "never waits for a card)")
        yield report
        return
    report.active = True
    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield report
        finally:
            torch.cuda.set_sync_debug_mode(old)
            report.messages = [str(w.message) for w in caught
                               if _SYNC_WARNING in str(w.message)]
    if report.syncs > allow:
        raise HostSyncError(
            f"{report.syncs} synchronizing CUDA call(s) inside sanitized "
            f"block (allow={allow}): {report.messages[:3]}"
        )
