"""defer_tpu_torch.fleet — prefix-aware routing + admission control over N
replica decode servers.

The DEFER front node, serving-shaped: one entry point fans requests
over multiple `PagedDecodeServer` replicas, placing each request where
its KV state already lives (the radix cache's chained token-ancestry
digests make "who holds this prompt's prefix" an exact lookup), and
degrading overload into typed rejections instead of collapsed tail
latency:

  * `router`    — digest advertisements, the prefix/migrate/load/
                  fallback decision ladder, deterministic tie-breaks
  * `admission` — bounded per-replica queues, SLO-deadline waits
                  (runtime/batching.py::Deadline), `ShedError`
  * `replica`   — one server per serving thread, single-writer ops
                  queue, `ReplicaDeadError` failure semantics
  * `api`       — `serve_fleet()` / `FleetFrontend`, token-identical
                  to `serve_paged` at n_replicas=1

Counterpart of `defer_tpu/fleet/` (see ARCHITECTURE.md "Fleet
serving"). Replicas are `PagedDecodeServer(device=...)` servers; on one
card they all share it and its one set of weights, each with its own
pool, and a decode window's CUDA graph captures thread-locally, so one
replica captures while the others serve.
"""

from defer_tpu_torch.fleet.admission import AdmissionController, ShedError
from defer_tpu_torch.fleet.api import FleetFrontend, serve_fleet
from defer_tpu_torch.fleet.replica import ReplicaDeadError, ThreadReplica
from defer_tpu_torch.fleet.router import (
    AdvertisementBoard,
    PrefixRouter,
    RouteDecision,
    chain_digests,
)

__all__ = [
    "AdmissionController",
    "AdvertisementBoard",
    "FleetFrontend",
    "PrefixRouter",
    "ReplicaDeadError",
    "RouteDecision",
    "ShedError",
    "ThreadReplica",
    "chain_digests",
    "serve_fleet",
]
