"""The port's `PeriodicDumper` (obs/export.py) and fleet instruments
(obs/serving.py `FleetMetrics`, `FleetStats`) against the JAX package's.

The dumper mirrors tests/test_obs.py: one JSON line a dump to a file, a
refused format; then the same registry dumped by both packages' dumpers
gives the same JSON and Prometheus text, the daemon thread writes on its
interval and stops (waits have timeouts, never open-ended sleeps), and
with no path the text goes to the logger. `FleetMetrics` registers the
JAX package's names, labels, routing and shed reasons.
"""

import json
import logging
import time

import pytest

from defer_tpu.obs import FleetMetrics as JaxFleetMetrics
from defer_tpu.obs import MetricsRegistry as JaxRegistry
from defer_tpu.obs import PeriodicDumper as JaxDumper
from defer_tpu_torch.obs import (
    FleetMetrics,
    FleetStats,
    MetricsRegistry,
    PeriodicDumper,
)


def _fill(r):
    r.counter("dump_total", "dumps", {"k": "v"}).inc(9)
    r.gauge("depth", "queue depth").set(3)
    r.histogram("wait_seconds", "waits", [0.1, 1.0]).observe(0.5)
    return r


def test_periodic_dumper_writes_file(tmp_path):
    r = MetricsRegistry()
    r.counter("dump_total").inc(9)
    path = tmp_path / "metrics.jsonl"
    d = PeriodicDumper(r, interval_s=60.0, path=str(path), fmt="json")
    d.dump_once()
    line = path.read_text().strip()
    assert json.loads(line)["counters"]["dump_total"] == 9
    with pytest.raises(ValueError, match="json|prometheus"):
        PeriodicDumper(r, fmt="xml")
    with pytest.raises(ValueError, match="interval_s"):
        PeriodicDumper(r, interval_s=0)


@pytest.mark.parametrize("fmt", ["json", "prometheus"])
def test_dump_equals_the_jax_package(tmp_path, fmt):
    """The same instruments dumped by both packages' dumpers are the
    same text, byte for byte."""
    got = PeriodicDumper(_fill(MetricsRegistry()), path=str(tmp_path / "a"),
                         fmt=fmt).dump_once()
    want = JaxDumper(_fill(JaxRegistry()), path=str(tmp_path / "b"),
                     fmt=fmt).dump_once()
    assert got == want
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()


def _dumps(path) -> int:
    return path.read_text().count("# TYPE dump_total") if path.exists() \
        else 0


def test_dumper_thread_writes_on_its_interval_and_stops(tmp_path):
    """start() dumps every interval from a daemon thread; the context
    manager stops it with one final dump; start() twice is refused."""
    r = _fill(MetricsRegistry())
    path = tmp_path / "m.prom"
    with PeriodicDumper(r, interval_s=0.02, path=str(path),
                        fmt="prometheus") as d:
        with pytest.raises(RuntimeError, match="already started"):
            d.start()
        t0 = time.monotonic()
        while _dumps(path) < 2:
            assert time.monotonic() - t0 < 10, "no periodic dumps"
            time.sleep(0.005)
        thread = d._thread
    assert d._thread is None and not thread.is_alive()
    assert _dumps(path) >= 3  # two periodic dumps at least, then the final
    assert 'dump_total{k="v"} 9' in path.read_text()


def test_dumper_logs_without_a_path(caplog):
    r = _fill(MetricsRegistry())
    d = PeriodicDumper(r, fmt="json")
    # The port's loggers do not propagate to the root: listen on this one.
    logger = logging.getLogger("defer_tpu_torch.obs.export")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            text = d.dump_once()
    finally:
        logger.removeHandler(caplog.handler)
    assert json.loads(text)["gauges"]["depth"] == 3
    assert any("metrics:" in rec.getMessage() for rec in caplog.records)


def test_fleet_metrics_are_the_jax_instruments():
    """Each fleet instrument has the JAX package's name, type, labels and
    help; the routing and shed reasons are the JAX package's."""
    got, want = MetricsRegistry(), JaxRegistry()
    FleetMetrics(2, got)
    JaxFleetMetrics(2, want)
    assert FleetMetrics.ROUTE_REASONS == JaxFleetMetrics.ROUTE_REASONS
    assert FleetMetrics.SHED_REASONS == JaxFleetMetrics.SHED_REASONS
    assert got.to_prometheus() == want.to_prometheus()
    stats = FleetStats.snapshot(got, n_replicas=2)
    assert stats.n_replicas == 2 and "metrics" in stats
