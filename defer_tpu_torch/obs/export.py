"""Export sinks for the metrics registry (the pull-based half of
`defer_tpu/obs/export.py`): `prometheus_text(registry)` renders the text
exposition format 0.0.4; `MetricsRegistry.to_dict()` (obs/metrics.py)
keys its snapshot by `sample_name`.
"""

from __future__ import annotations

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
