"""Serving-layer metric handles and the structured stats snapshot.

Counterpart of `defer_tpu/obs/serving.py` (`ServingMetrics`,
`ServerStats`), over the port's `obs/metrics.py`, so the port's decode
server exports the JAX package's metric names. `ServingMetrics` resolves
every instrument once, at server construction; the per-token path then
touches pre-bound attributes only. The flat server's decode windows
report `defer_host_dispatches_total`, `defer_tokens_per_dispatch` and
`defer_window_truncated_total`; constrained decoding
`defer_constrained_tokens_total`, `defer_constrain_masked_frac` and
`defer_constrain_dead_ends_total`; speculative decoding
(models/speculative.py, label "speculative") the `defer_spec_*`
counters and the `defer_spec_acceptance` histogram. The pipeline
stages' instruments (`bind_pp`) bind once a pp_stages > 1 server knows
its stage count.
`DisaggMetrics` instruments the disaggregated prefill/decode split
(defer_tpu_torch/disagg/); `FleetMetrics` the fleet front-end
(defer_tpu_torch/fleet/), with the JAX package's names, labels and
reasons.

`ServerStats` is the structured return of `serve_greedy`: a dict with
attribute access and the registry snapshot under `stats.metrics`;
`FleetStats` is `serve_fleet`'s.
"""

from __future__ import annotations

from typing import Any

from defer_tpu_torch.obs.metrics import MetricsRegistry, get_registry

# Latency edges: 0.1 ms .. ~1.6 s (x2). Decode ticks on the CPU test
# rig land mid-range; queue waits under load reach the top.
_LATENCY_BUCKETS = tuple(1e-4 * 2.0**i for i in range(15))


class ServingMetrics:
    """Pre-bound instrument handles for one decode server flavour."""

    def __init__(
        self,
        server: str,
        registry: MetricsRegistry | None = None,
        mesh_shape: str | None = None,
    ):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        labels = {"server": server}
        # Topology-auditable instruments additionally carry the mesh
        # shape (e.g. "model=4") when the server runs tensor-parallel,
        # so per-shard dispatch/bandwidth claims are separable from the
        # single-device series; mesh_shape=None keeps the label set —
        # and thus the exposition identity — exactly as before.
        mesh_labels = dict(labels)
        if mesh_shape is not None:
            mesh_labels["mesh"] = mesh_shape
        self.requests_admitted = reg.counter(
            "defer_requests_admitted_total",
            "Requests admitted into a decode slot", labels,
        )
        self.requests_finished = reg.counter(
            "defer_requests_finished_total",
            "Requests that finished decoding", labels,
        )
        self.ticks = reg.counter(
            "defer_decode_ticks_total",
            "Batched decode steps executed", labels,
        )
        self.tokens_generated = reg.counter(
            "defer_tokens_generated_total",
            "Tokens emitted by decode slots (incl. first token)", labels,
        )
        self.prefill_tokens = reg.counter(
            "defer_prefill_tokens_total",
            "Prompt tokens run through prefill", labels,
        )
        self.ttft = reg.histogram(
            "defer_ttft_seconds",
            "Admission to first-token dispatch (host-side; the token "
            "array may still be in flight on device)",
            _LATENCY_BUCKETS, labels,
        )
        self.itl = reg.histogram(
            "defer_itl_seconds",
            "Inter-token latency: host wall time between decode ticks, "
            "weighted by active slots",
            _LATENCY_BUCKETS, labels,
        )
        self.queue_wait = reg.histogram(
            "defer_queue_wait_seconds",
            "submit() to admission", _LATENCY_BUCKETS, labels,
        )
        # Paged-only pool/cache instruments; registered for both
        # flavours (flat just leaves them at zero) so exposition shape
        # does not depend on which server ran first.
        self.pool_blocks_free = reg.gauge(
            "defer_pool_blocks_free", "KV pool blocks on the free list",
            labels,
        )
        self.pool_blocks_used = reg.gauge(
            "defer_pool_blocks_used", "KV pool blocks held by slots",
            labels,
        )
        self.prefix_hits = reg.counter(
            "defer_prefix_cache_hits_total",
            "Prompt blocks served from the radix cache", labels,
        )
        self.prefix_misses = reg.counter(
            "defer_prefix_cache_misses_total",
            "Full prompt blocks that had to be prefilled", labels,
        )
        self.prefix_evictions = reg.counter(
            "defer_prefix_cache_evictions_total",
            "Parked cache blocks reclaimed under pool pressure", labels,
        )
        self.prefix_parks = reg.counter(
            "defer_prefix_cache_parks_total",
            "Cache blocks parked at refcount zero (LRU candidates)",
            labels,
        )
        self.prefix_revivals = reg.counter(
            "defer_prefix_cache_revivals_total",
            "Parked cache blocks revived by a new sharer", labels,
        )
        # KV-pool storage + host-RAM spill tier (runtime/paged.py
        # kv_dtype= / spill_bytes=). kv_pool_bytes is the pool's
        # RESIDENCY footprint — int8 pools read ~0.5x an fp pool plus
        # scale overhead — while the row counters above stay dtype-
        # agnostic (a row is a token position whatever its byte
        # width). spill_bytes is a gauge: the store's current
        # occupancy, trimmed oldest-first against its cap.
        self.kv_pool_bytes = reg.gauge(
            "defer_kv_pool_bytes",
            "Total bytes of the paged KV pool as allocated (K + V "
            "payloads plus int8 block scales when kv_dtype='int8')",
            labels,
        )
        self.prefix_spilled = reg.counter(
            "defer_prefix_spilled_total",
            "Evicted prefix blocks drained into the host-RAM spill "
            "store", labels,
        )
        self.prefix_spill_hits = reg.counter(
            "defer_prefix_spill_hits_total",
            "Radix walk misses served from the spill store (block "
            "revived into the pool instead of re-prefilled)", labels,
        )
        self.spill_bytes = reg.gauge(
            "defer_prefix_spill_bytes",
            "Current bytes resident in the host-RAM spill store",
            labels,
        )
        # Block-native attention accounting (runtime/paged.py): rows
        # the tick's attention path actually read vs what the gathered
        # full-pool-view path reads regardless of depth. One unit =
        # one K/V row pair (token position) for one slot for one tick,
        # layer/head-agnostic — multiply by 2 * L * Hkv * Dh * itemsize
        # for bytes. The ratio read/baseline is the bandwidth win.
        self.kv_rows_read = reg.counter(
            "defer_kv_rows_read_total",
            "KV cache rows (token positions, K+V pair = 1 unit, "
            "layer-agnostic) read by decode-tick attention, summed "
            "over slots; PER-SHARD under a mesh (each shard holds "
            "kv_heads/TP heads, so reads scale as 1/TP)", mesh_labels,
        )
        self.kv_rows_gathered = reg.counter(
            "defer_kv_rows_gathered_baseline_total",
            "Rows the gathered full-pool-view path would have read "
            "for the same ticks (B * max_blocks * block_size each)",
            labels,
        )
        self.kv_rows_last = reg.gauge(
            "defer_kv_rows_read_last_tick",
            "KV rows read by the most recent decode tick", labels,
        )
        # Dispatch-efficiency instruments (fused decode windows,
        # runtime/*.py `decode_window`): one host dispatch drives up
        # to K decode sub-steps, so dispatches-per-token falls toward
        # 1/K while tokens_per_dispatch rises toward K * active slots.
        # At decode_window=1 host_dispatches == decode_ticks and the
        # gauge reads the active-slot count.
        self.host_dispatches = reg.counter(
            "defer_host_dispatches_total",
            "Decode-loop host dispatches (one per window; equals "
            "decode ticks at decode_window=1). Unchanged by tensor "
            "parallelism — one dispatch drives all shards",
            mesh_labels,
        )
        self.tp_psums = reg.counter(
            "defer_tp_psum_total",
            "Cross-shard collectives issued by sharded tick bodies "
            "(2 per layer + embed psum + logits all-gather per "
            "forward); zero on mesh=None", mesh_labels,
        )
        self.tokens_per_dispatch = reg.gauge(
            "defer_tokens_per_dispatch",
            "Tokens accepted from the most recent decode dispatch",
            labels,
        )
        self.window_truncated = reg.counter(
            "defer_window_truncated_total",
            "Decode windows a slot cut short (eos froze the row "
            "on-device, or a stop sequence discarded the tail on "
            "drain)", labels,
        )
        # Continuous-batching interference (runtime/schedule.py +
        # runtime/paged.py `prefill_budget=`): how much decode time
        # admission prefill steals. In the serialized stall path every
        # prefill dispatch issued while a decode slot is live is a
        # stall tick; mixed-mode ticks carry prompt chunks inside the
        # decode dispatch instead, so stall ticks stay 0 and the
        # fraction gauge reads ~0.
        self.prefill_stall_ticks = reg.counter(
            "defer_prefill_stall_ticks_total",
            "Admission-prefill dispatches issued while at least one "
            "decode slot sat stalled waiting for the tick loop "
            "(serialized-prefill interference; 0 under "
            "prefill_budget=)", labels,
        )
        self.mixed_prefill_tokens = reg.counter(
            "defer_mixed_prefill_tokens_total",
            "Prompt tokens carried by fused mixed decode+prefill "
            "dispatches (prefill_budget= ticks)", labels,
        )
        self.decode_stall_fraction = reg.gauge(
            "defer_decode_stall_fraction",
            "Fraction of decode-capable dispatch slots spent stalled "
            "behind admission prefill: stall_ticks / (decode_ticks + "
            "stall_ticks)", labels,
        )
        # Speculative decoding (models/speculative.py solo loop and
        # runtime/paged.py paged serving both report through these).
        # acceptance = accepted/proposed is the one-number health
        # signal: the target-dispatch amortization k-token speculation
        # buys is (1 + acceptance * k) tokens per verify forward.
        self.spec_proposed = reg.counter(
            "defer_spec_proposed_total",
            "Draft tokens proposed to a target verify forward", labels,
        )
        self.spec_accepted = reg.counter(
            "defer_spec_accepted_total",
            "Proposed draft tokens the target accepted", labels,
        )
        self.spec_rounds = reg.counter(
            "defer_spec_rounds_total",
            "Speculative propose/verify rounds executed", labels,
        )
        self.spec_draft_tokens = reg.counter(
            "defer_spec_draft_tokens_total",
            "Tokens the DRAFT model computed forwards for (catch-up "
            "feeds + proposal scan steps) — the speculation overhead "
            "side of the acceptance-vs-speedup frontier", labels,
        )
        # Per-round accepted-length distribution: one observation per
        # greedy slot per round, value = draft tokens accepted in
        # [0, k]. Integer-edge buckets make `le="a"` read "rounds that
        # accepted <= a proposals"; the running mean (sum/count) is
        # the old gauge's acceptance*k. Edges cover k <= 16; larger k
        # folds into +Inf, still mean-exact.
        self.spec_acceptance = reg.histogram(
            "defer_spec_acceptance",
            "Accepted draft tokens per speculative round per slot "
            "(distribution; mean = acceptance * spec_k)",
            tuple(float(b) for b in range(17)),
            labels,
        )
        # Constrained decoding (defer_tpu/constrain/): tokens emitted
        # under a DFA mask, and how much of the vocabulary that mask
        # removed per token — masked_frac near 1.0 means the grammar
        # is doing almost all the choosing (JSON punctuation states),
        # near 0.0 means the constraint is along for the ride.
        self.constrained_tokens = reg.counter(
            "defer_constrained_tokens_total",
            "Tokens emitted by slots decoding under a constraint DFA "
            "mask (defer_tpu/constrain/)", labels,
        )
        self.constrain_masked_frac = reg.histogram(
            "defer_constrain_masked_frac",
            "Per-token fraction of the vocabulary the constraint "
            "mask removed (1.0 = grammar-forced, 0.0 = free)",
            tuple(i / 10.0 for i in range(1, 11)),
            labels,
        )
        self.constrain_dead_ends = reg.counter(
            "defer_constrain_dead_ends_total",
            "Requests failed because their (hand-built) constraint "
            "DFA reached a state admitting no token — compiled DFAs "
            "are dead-end-free by construction", labels,
        )
        # Pipeline-parallel serving (runtime/paged.py pp_stages=):
        # schedule-level health of the staged decode loop. Bubble is
        # 1 - mean stage occupancy over the realized dispatch
        # schedule (fill/drain slots plus any group that froze
        # mid-window), NOT the closed-form (S-1)/(S-1+M*W). The
        # per-stage instruments live behind bind_pp() because their
        # label set depends on the stage count.
        self.pp_bubble_fraction = reg.gauge(
            "defer_pp_bubble_fraction",
            "1 - mean stage occupancy of the most recent pipelined "
            "decode window (0 on pp_stages=1 servers)", labels,
        )
        self.pp_inflight = reg.gauge(
            "defer_pp_inflight_microbatches",
            "Microbatch slot groups in flight through the stage "
            "chain (M; 0 on pp_stages=1 servers)", labels,
        )
        self.pp_stage_occupancy: list = []
        self.pp_stage_dispatches: list = []

    def bind_pp(self, num_stages: int) -> None:
        """Resolve the per-stage pipeline instruments (stage-labeled,
        so the label set depends on the server's stage count — the
        FleetMetrics per-replica idiom). Idempotent: the registry
        get-or-creates, so two servers with the same stage count share
        handles."""
        reg = self.registry
        per = [{"stage": str(s)} for s in range(num_stages)]
        self.pp_stage_occupancy = [
            reg.gauge(
                "defer_pp_stage_occupancy",
                "Fraction of the realized window schedule's dispatch "
                "slots this stage spent busy (per stage)",
                lab,
            )
            for lab in per
        ]
        self.pp_stage_dispatches = [
            reg.counter(
                "defer_pp_stage_dispatches_total",
                "Stage-step dispatches issued to this pipeline stage "
                "(one per microbatch per decode round)",
                lab,
            )
            for lab in per
        ]


class DisaggMetrics:
    """Pre-bound instruments for one disaggregated-serving role.

    Both halves of a prefill/decode split emit the same names and
    differ by the `role` label ("prefill" | "decode"), the `server`
    label convention above. Byte counters count WIRE bytes (transport
    header + codec frame), so sent and received agree exactly on a
    lossless link and the sent/raw ratio prices the quantized mode."""

    def __init__(self, role: str, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        labels = {"role": role}
        self.kv_blocks_shipped = reg.counter(
            "defer_kv_blocks_shipped_total",
            "Finished KV pool blocks framed onto the wire (full blocks "
            "plus at most one tail block per request)", labels,
        )
        self.kv_bytes_sent = reg.counter(
            "defer_kv_block_bytes_sent_total",
            "Wire bytes of KV-block payload frames sent", labels,
        )
        self.kv_bytes_recv = reg.counter(
            "defer_kv_block_bytes_recv_total",
            "Wire bytes of KV-block payload frames received", labels,
        )
        self.ingest_wait = reg.histogram(
            "defer_kv_ingest_wait_seconds",
            "Received KV payload parked in the ingest queue before the "
            "decode server admitted it", _LATENCY_BUCKETS, labels,
        )
        self.worker_restarts = reg.counter(
            "defer_disagg_worker_restarts_total",
            "Prefill worker sessions restarted after a mid-stream "
            "transport failure", labels,
        )


class FleetMetrics:
    """Pre-bound instruments for the fleet front-end
    (defer_tpu_torch/fleet/). One process-wide set of fleet instruments; the
    per-replica signals (queue depth/wait, in-flight slots, pool
    headroom) carry a `replica` label because every replica's OWN
    `ServingMetrics("paged")` resolves to the same shared instruments
    — per-replica load must be separable for the router to read it."""

    ROUTE_REASONS = ("prefix", "migrate", "load", "fallback")
    SHED_REASONS = ("queue_full", "slo")

    def __init__(
        self, n_replicas: int, registry: MetricsRegistry | None = None
    ):
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.n_replicas = n_replicas
        self.routed = {
            reason: reg.counter(
                "defer_fleet_routed_total",
                "Requests routed to a replica, by routing reason "
                "(prefix = deepest resident prefix; migrate = prefix "
                "holder overloaded, blocks shipped to the target; "
                "load = no resident prefix anywhere, least-loaded; "
                "fallback = prefix existed but was unusable — holder "
                "dead or migration failed)",
                {"reason": reason},
            )
            for reason in self.ROUTE_REASONS
        }
        self.shed = {
            reason: reg.counter(
                "defer_fleet_shed_total",
                "Requests rejected by admission control, by reason "
                "(queue_full = bounded queue never drained within the "
                "deadline; slo = rolling queue-wait p99 already above "
                "the configured SLO)",
                {"reason": reason},
            )
            for reason in self.SHED_REASONS
        }
        self.migrated_blocks = reg.counter(
            "defer_fleet_migrated_blocks_total",
            "Prefix KV blocks shipped between replica pools instead "
            "of being re-prefilled",
        )
        self.advert_age = reg.gauge(
            "defer_fleet_digest_advert_age_seconds",
            "Age of the OLDEST replica digest advertisement at the "
            "most recent routing decision — how stale the prefix "
            "signal can be",
        )
        per = [{"replica": str(i)} for i in range(n_replicas)]
        self.queue_wait = [
            reg.histogram(
                "defer_fleet_queue_wait_seconds",
                "Admission enqueue to replica pickup, per replica",
                _LATENCY_BUCKETS, lab,
            )
            for lab in per
        ]
        self.queue_depth = [
            reg.gauge(
                "defer_fleet_queue_depth",
                "Requests waiting in a replica's admission queue",
                lab,
            )
            for lab in per
        ]
        self.inflight = [
            reg.gauge(
                "defer_fleet_inflight_requests",
                "Requests seated or pending inside a replica's server",
                lab,
            )
            for lab in per
        ]
        self.pool_free = [
            reg.gauge(
                "defer_fleet_pool_blocks_free",
                "Replica KV pool headroom (free-list blocks)",
                lab,
            )
            for lab in per
        ]


class ServerStats(dict):
    """Dict-compatible structured stats snapshot.

    Existing call sites index it (`stats["ticks"]`, `**stats`); new
    code reads attributes (`stats.ticks`, `stats.metrics`). The
    `metrics` key holds `registry.to_dict()` at snapshot time."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def snapshot(
        cls, registry: MetricsRegistry | None = None, **fields
    ) -> "ServerStats":
        reg = registry if registry is not None else get_registry()
        out = cls(fields)
        out["metrics"] = reg.to_dict()
        return out


class FleetStats(ServerStats):
    """ServerStats for a fleet run: the fleet-level snapshot (routing
    reasons, shed counts, migration totals) plus `replicas`, a list of
    per-replica ServerStats in replica-index order."""
