"""Export sinks for the metrics registry (counterpart of
`defer_tpu/obs/export.py`): `prometheus_text(registry)` renders the text
exposition format 0.0.4; `MetricsRegistry.to_dict()` (obs/metrics.py)
keys its snapshot by `sample_name`; `PeriodicDumper` pushes either form
to a file or the logger from a daemon thread.
"""

from __future__ import annotations

import json
import threading

from defer_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

def _escape(v: str) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _render_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def sample_name(name: str, labels: dict, extra: dict | None = None) -> str:
    return name + _render_labels(labels, extra)


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(registry) -> str:
    """Render every instrument in Prometheus text exposition format.

    Deterministic output: instruments sorted by (name, labels), one
    HELP/TYPE header per metric name, histogram buckets cumulative
    with a trailing +Inf — so a golden-string test pins the format."""
    from defer_tpu_torch.obs.metrics import Counter, Gauge, Histogram

    metrics = sorted(
        registry, key=lambda m: (m.name, sorted(m.labels.items()))
    )
    lines: list[str] = []
    seen_header: set[str] = set()
    for m in metrics:
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            kind = {
                Counter: "counter", Gauge: "gauge", Histogram: "histogram"
            }[type(m)]
            lines.append(f"# TYPE {m.name} {kind}")
        if isinstance(m, Histogram):
            snap = m._snapshot()
            for le, cum in snap["buckets"]:
                le_s = le if le == "+Inf" else _fmt(le)
                lines.append(
                    f"{m.name}_bucket"
                    f"{_render_labels(m.labels, {'le': le_s})} {cum}"
                )
            lines.append(
                f"{m.name}_sum{_render_labels(m.labels)} "
                f"{_fmt(snap['sum'])}"
            )
            lines.append(
                f"{m.name}_count{_render_labels(m.labels)} "
                f"{snap['count']}"
            )
        else:
            lines.append(
                f"{sample_name(m.name, m.labels)} {_fmt(m._snapshot())}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


class PeriodicDumper:
    """Daemon thread that snapshots the registry every `interval_s`
    and writes it to a file (`path`) or the module logger. The thread
    only ever *reads* instruments, so a dumper costs the hot paths
    nothing; `fmt` is "json" or "prometheus"."""

    def __init__(
        self,
        registry,
        interval_s: float = 10.0,
        path: str | None = None,
        fmt: str = "json",
    ):
        if fmt not in ("json", "prometheus"):
            raise ValueError(f"fmt must be json|prometheus, got {fmt!r}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.interval_s = interval_s
        self.path = path
        self.fmt = fmt
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _render(self) -> str:
        if self.fmt == "prometheus":
            return self.registry.to_prometheus()
        return json.dumps(self.registry.to_dict(), sort_keys=True)

    def dump_once(self) -> str:
        text = self._render()
        if self.path:
            with open(self.path, "a") as f:
                f.write(text if text.endswith("\n") else text + "\n")
        else:
            log.info("metrics: %s", text)
        return text

    # analysis: domain(transport) periodic exposition writes leave the
    # process; server state is only read
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.dump_once()
            except Exception:  # a broken sink must not kill the server
                log.exception("metrics dump failed")

    def start(self) -> "PeriodicDumper":
        if self._thread is not None:
            raise RuntimeError("dumper already started")
        self._thread = threading.Thread(
            target=self._run, name="obs-dumper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_dump: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_dump:
            self.dump_once()

    def __enter__(self) -> "PeriodicDumper":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(final_dump=not any(exc))
