"""Prefix-aware request routing: cache locality as the placement
signal. Counterpart of `defer_tpu/fleet/router.py`, with the same
digests, decision ladder and tie-breaks.

DEFER's front node dispatches work across compute nodes; TensorFlow's
placer assigns ops to the device whose state they read. This router is
the serving version of both ideas: a `PrefixBlockCache` keys blocks by
EXACT chained blake2b token-ancestry digests, so "which replica
already holds this prompt's prefix" is a set lookup, not a heuristic.
Each replica advertises its resident digest set (a cheap generation-
gated snapshot, `PagedDecodeServer.resident_digests`); the router
chains each incoming prompt's digests with the SAME hash and walks
them against the advertisements to find the deepest resident run.

Decision ladder (reasons match FleetMetrics.ROUTE_REASONS):

  * `prefix`   — a live replica holds a non-empty leading run of the
                 prompt's blocks and isn't badly overloaded: route to
                 it; admission revives the parked blocks for free.
  * `migrate`  — the deepest holder is overloaded relative to the
                 least-loaded replica by more than `migrate_gap`:
                 ship the parked chain (disagg/wire.py PrefixPayload)
                 to the least-loaded replica and route there — the
                 prefix travels to the capacity instead of the request
                 queueing behind the hot replica.
  * `load`     — no replica holds any of the prompt's blocks: route
                 least-loaded.
  * `fallback` — a prefix exists somewhere but is unusable (holder
                 dead, or migration disabled/failed): least-loaded,
                 counted separately because it is exactly the routing
                 quality the advertisement freshness budget buys.

Load is read from the fleet obs gauges the replicas maintain
(`queue_depth + inflight`, pool headroom as the tie-breaker, replica
index as the deterministic final tie-break), so routing decisions are
measured, not guessed — and reproducible under equal load.

Advertisement discipline: replicas snapshot their digest set UNDER the
radix lock and publish OUTSIDE it (the board takes its own lock). A
publish inside the radix lock would serialize admission against
whatever the advertisement fanout does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np

import torch

from defer_tpu_torch.runtime.paged import PrefixBlockCache


def chain_digests(tokens: Any, n_full: int, bs: int) -> list[bytes]:
    """The routing-side twin of PrefixBlockCache.walk's key pass:
    chained digests for the prompt's leading `n_full` full blocks,
    byte-identical to what the replica caches register under (same
    `_hash`, same int64 token encoding) — the router and the caches
    must agree bit-for-bit or every lookup silently misses. `tokens`
    is a tensor (read to the host once a REQUEST, at admission) or an
    array."""
    if isinstance(tokens, torch.Tensor):
        # analysis: ignore[host-sync-in-hot-loop] routing hashes prompt tokens
        # once a request, at admission, not a tick
        tokens = tokens.cpu().numpy()
    flat = np.asarray(tokens).reshape(-1)[: n_full * bs].astype(np.int64)
    keys: list[bytes] = []
    prev = b""
    for j in range(n_full):
        prev = PrefixBlockCache._hash(
            prev, flat[j * bs : (j + 1) * bs].tobytes()
        )
        keys.append(prev)
    return keys


class AdvertisementBoard:
    """Last-published digest snapshot per replica, with its generation
    and publish timestamp. Publishers (replica serving threads) and
    the reading router contend only on this board's own lock, never on
    any replica's radix lock."""

    def __init__(self, n_replicas: int):
        self._lock = threading.Lock()
        self._adverts: list[tuple[int, frozenset, float]] = [
            (-1, frozenset(), time.monotonic())
            for _ in range(n_replicas)
        ]

    def publish(
        self, idx: int, generation: int, digests: frozenset
    ) -> None:
        with self._lock:
            self._adverts[idx] = (generation, digests, time.monotonic())

    def snapshot(self) -> list[tuple[int, frozenset, float]]:
        with self._lock:
            return list(self._adverts)


@dataclasses.dataclass
class RouteDecision:
    """Where one request goes and why. `keys` is the chained-digest
    run backing a prefix/migrate decision (what to export); `source`
    is the overloaded holder a `migrate` ships from."""

    replica: int
    reason: str
    depth: int = 0
    keys: list = dataclasses.field(default_factory=list)
    source: int | None = None


class PrefixRouter:
    """Stateless-per-request routing over the advertisement board.

    `policy="prefix"` is the real router; `policy="round_robin"`
    ignores the advertisements entirely (deterministic rotation over
    live replicas) and exists as the control arm every prefix-aware
    claim is measured against (scripts/bench_fleet.py)."""

    def __init__(
        self,
        board: AdvertisementBoard,
        obs: Any,
        *,
        policy: str = "prefix",
        migrate: bool = True,
        migrate_gap: int = 4,
    ):
        if policy not in ("prefix", "round_robin"):
            raise ValueError(
                f"policy must be 'prefix' or 'round_robin', got "
                f"{policy!r}"
            )
        self.board = board
        self.obs = obs
        self.policy = policy
        self.migrate = migrate
        self.migrate_gap = migrate_gap
        self._rr = 0

    def _load(self, idx: int) -> tuple:
        """Deterministic load score, smaller = less loaded: queued +
        in-flight work first, then the LEAST pool headroom last
        (negated free blocks), then the replica index so equal load
        breaks ties identically on every run."""
        return (
            self.obs.queue_depth[idx].value
            + self.obs.inflight[idx].value,
            -self.obs.pool_free[idx].value,
            idx,
        )

    def route(
        self,
        tokens: Any,
        n_full: int,
        bs: int,
        alive: list[bool],
    ) -> RouteDecision:
        """One placement decision. `alive[i]` False excludes replica i
        as a TARGET while its (stale) advertisement still counts as "a
        prefix existed" — a dead holder routes `fallback`, not `load`,
        so the death shows up in the routing mix instead of vanishing."""
        if not any(alive):
            raise RuntimeError("no live replicas to route to")
        adverts = self.board.snapshot()
        now = time.monotonic()
        self.obs.advert_age.set(
            max(
                now - t
                for i, (_, _, t) in enumerate(adverts)
                if alive[i]
            )
        )
        if self.policy == "round_robin":
            n = len(alive)
            for _ in range(n):
                idx = self._rr % n
                self._rr += 1
                if alive[idx]:
                    return RouteDecision(idx, "load")
        keys = chain_digests(tokens, n_full, bs)
        best_idx, best_depth = -1, 0
        for i, (_, digests, _) in enumerate(adverts):
            depth = 0
            for key in keys:
                if key not in digests:
                    break
                depth += 1
            # Strict > : equal depth keeps the lower index, the same
            # deterministic tie-break direction as _load's final key.
            if depth > best_depth:
                best_idx, best_depth = i, depth
        least = min(
            (i for i in range(len(alive)) if alive[i]), key=self._load
        )
        if best_depth == 0:
            return RouteDecision(least, "load")
        if not alive[best_idx]:
            return RouteDecision(least, "fallback", best_depth)
        holder_load = self._load(best_idx)[0]
        least_load = self._load(least)[0]
        if (
            best_idx != least
            and holder_load - least_load >= self.migrate_gap
        ):
            if self.migrate:
                return RouteDecision(
                    least,
                    "migrate",
                    best_depth,
                    keys[:best_depth],
                    source=best_idx,
                )
            return RouteDecision(least, "fallback", best_depth)
        return RouteDecision(
            best_idx, "prefix", best_depth, keys[:best_depth]
        )
