"""defer_tpu_torch.obs — always-on metrics for the pipeline runtimes."""

from defer_tpu_torch.obs.export import prometheus_text
from defer_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter_deltas,
    get_registry,
    log_buckets,
    reset,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter_deltas",
    "get_registry",
    "log_buckets",
    "prometheus_text",
    "reset",
]
