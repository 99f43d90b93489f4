"""Zero-dependency metrics core: Counter / Gauge / Histogram behind a
process-global, resettable MetricsRegistry.

A copy of `defer_tpu/obs/metrics.py` (pure Python), so the port exports
the same metric names (`defer_pipeline_microbatches_total`,
`defer_stream_items_total`, ...) without importing the JAX package.
The pipeline and stream runtimes increment always-on instruments, and
export sinks (`obs/export.py`) read them on demand — nothing is paid per
sample beyond an add under a lock. Counters of time (`..._seconds_total`)
add float seconds, from one `time.perf_counter_ns()` pair a boundary.

Design constraints, in order:

  * **Hot-path cost**: instrument handles are resolved ONCE (at
    construction) and cached; an event is then a lock acquire + an
    add, no allocation. Histograms use FIXED log-spaced bucket edges
    found by `bisect`, so observing never allocates either.
  * **Thread safety**: every mutation takes the instrument's own lock
    (int += under the GIL is NOT atomic).
  * **Resettable, never replaced**: `reset()` zeroes every instrument
    IN PLACE rather than swapping the registry object, so cached
    handles stay valid across test boundaries.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from typing import Any


def log_buckets(
    start: float = 1e-4, factor: float = 2.0, count: int = 20
) -> tuple[float, ...]:
    """Fixed log-spaced histogram edges: start * factor**i. The
    default (0.1 ms .. ~52 s, x2) covers queue waits, TTFT, and
    inter-token latency on anything from a CPU test to a loaded server
    without per-workload tuning."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; got "
            f"{start}/{factor}/{count}"
        )
    return tuple(start * factor**i for i in range(count))


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotonically increasing count (Prometheus counter)."""

    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(
        self, name: str, help: str = "", labels: dict | None = None
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value


class Gauge:
    """Point-in-time value that can go both ways (pool occupancy,
    per-stage step time)."""

    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(
        self, name: str, help: str = "", labels: dict | None = None
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: bucket i counts
    observations <= edges[i], plus an implicit +Inf overflow bucket).

    Edges are fixed at construction — log-spaced by default — so
    `observe` is one bisect + three int/float adds under the lock:
    no per-sample allocation, ever."""

    __slots__ = (
        "name", "help", "labels", "edges", "_lock", "_counts",
        "_sum", "_count",
    )

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: tuple | list | None = None,
        labels: dict | None = None,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        edges = tuple(buckets) if buckets is not None else log_buckets()
        if not edges or list(edges) != sorted(edges):
            raise ValueError(
                f"histogram {name} needs ascending non-empty edges"
            )
        self.edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)  # [..., +Inf]
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float, n: int = 1) -> None:
        """Record `v` (n times — one bisect either way; servers use
        n = active slots for the shared tick-to-tick latency)."""
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += v * n

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._count = 0

    def _snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        buckets = []
        for edge, c in zip(self.edges, counts):
            cum += c
            buckets.append([edge, cum])
        buckets.append(["+Inf", total])
        return {"count": total, "sum": s, "buckets": buckets}

    def approx_quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate (None when empty) —
        good enough for a bench headline, not for SLO accounting."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile {q} not in [0, 1]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return None
        target = q * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            if cum + c >= target and c:
                hi = (
                    self.edges[i]
                    if i < len(self.edges)
                    else self.edges[-1]
                )
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = self.edges[i] if i < len(self.edges) else self.edges[-1]
        return self.edges[-1]


class MetricsRegistry:
    """Get-or-create instrument store. Keyed by (name, labels): two
    call sites asking for the same name+labels share the instrument
    (that is how the flat and paged servers aggregate, and how a
    re-constructed server resumes its counters)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[tuple, Any] = {}

    def _get(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels=labels, **kw)
                self._metrics[key] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple | list | None = None,
        labels: dict | None = None,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def __iter__(self):
        with self._lock:
            return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        return len(self._metrics)

    def reset(self) -> None:
        """Zero every instrument IN PLACE. Cached handles stay valid —
        the test-isolation contract (a server built in one test keeps
        working after another test resets)."""
        for m in self:
            m._reset()

    def value(self, name: str, **labels):
        """Convenience read: the instrument's current value (counters
        and gauges) or snapshot dict (histograms); None if absent."""
        m = self._metrics.get((name, _label_key(labels)))
        return None if m is None else m._snapshot()

    def to_dict(self) -> dict:
        """JSON-ready snapshot: {"counters": {...}, "gauges": {...},
        "histograms": {...}} keyed by the Prometheus sample name
        (labels rendered inline, sorted)."""
        from defer_tpu_torch.obs.export import sample_name

        out = {"counters": {}, "gauges": {}, "histograms": {}}
        kind = {Counter: "counters", Gauge: "gauges", Histogram: "histograms"}
        for m in self:
            out[kind[type(m)]][sample_name(m.name, m.labels)] = (
                m._snapshot()
            )
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        from defer_tpu_torch.obs.export import prometheus_text

        return prometheus_text(self)


@contextlib.contextmanager
def counter_deltas(registry: MetricsRegistry | None = None):
    """Counter INCREMENTS across a with-block, as
    {prometheus sample name: delta}.

    The registry is process-global and cumulative (reset() exists for
    test isolation, but resetting mid-flight would zero instruments a
    live server is still driving), so "how much did THIS run read?"
    needs a before/after diff. Yields a dict that is empty inside the
    block and populated on exit with every counter whose value grew —
    counters created during the block diff against a baseline of 0.

        with counter_deltas() as d:
            serve_paged(...)
        d['defer_kv_rows_read_total{server="paged"}']
    """
    from defer_tpu_torch.obs.export import sample_name

    reg = registry if registry is not None else _REGISTRY
    before = {
        (m.name, _label_key(m.labels)): m._snapshot()
        for m in reg
        if isinstance(m, Counter)
    }
    out: dict[str, float] = {}
    yield out
    for m in reg:
        if not isinstance(m, Counter):
            continue
        d = m._snapshot() - before.get((m.name, _label_key(m.labels)), 0)
        if d:
            out[sample_name(m.name, m.labels)] = d


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """THE process registry. Intentionally a singleton accessor with no
    setter: hot paths cache handles out of it, and `reset()` zeroes in
    place so those handles survive (see module docstring). Tests that
    need a private registry construct MetricsRegistry() directly."""
    return _REGISTRY


def reset() -> None:
    """Zero the process registry in place (test isolation)."""
    _REGISTRY.reset()
