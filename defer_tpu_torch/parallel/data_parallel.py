"""Data-parallel inference: batch-sharded apply + replicated pipelines
(counterpart of `defer_tpu/parallel/data_parallel.py`).

The reference scales throughput exactly one way — deeper pipelines
(more compute nodes in the chain, reference src/dispatcher.py:47-63).
When the whole model fits one device, the other way is to split the
BATCH. Two runtimes:

  * `ShardedInference` — the whole graph on each device of an explicit
    list (every CUDA device by default): a batch is split into
    len(devices) shards, shard i runs on devices[i], and the results
    are concatenated in order on devices[0]. On one card that is
    `[cuda:0]`. Given a `Mesh` (the JAX package runs one SPMD program
    over its data axis), a one-process mesh takes its data axis's
    devices as the list; over a process group every rank takes the
    whole batch, runs its data index's shard on its own device, and
    all-gathers the results on its data-axis line, so every rank holds
    the whole output, as JAX's global array is whole.
  * `ReplicatedPipeline` — R independent device-pinned pipeline
    replicas (parallel/pipeline.py `Pipeline`) fed round-robin;
    composes data parallelism with the stage chain when the model does
    NOT fit one device (params spread over S devices, R x S total).
    In-order output merging preserves the stream contract.

Both present the Pipeline surface (`__call__`, `submit`, `stream`,
`throughput`), so the DEFER facade drives them interchangeably.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Sequence

import torch

from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.graph.ir import Graph, GraphParams
from defer_tpu_torch.graph.partition import StageGraph
from defer_tpu_torch.parallel import collectives
from defer_tpu_torch.parallel.mesh import Mesh, cuda_devices
from defer_tpu_torch.parallel.pipeline import (
    Pipeline,
    Stage,
    StreamMeasure,
    resolve_device,
)
from defer_tpu_torch.utils.logging import get_logger
from defer_tpu_torch.utils.sync import Pending, Retirer, hard_sync

log = get_logger(__name__)


class ReplicaRetirer:
    """Retirer bank for interleaved multi-replica streams.

    One Retirer per replica: the windowed-barrier trick ("sync one item,
    retire everything enqueued before it") relies on device program
    order, which only holds WITHIN one pipeline — a single shared
    Retirer over round-robin submissions would retire (and count as
    completed) items of a wedged sibling replica. Here each replica's
    items retire against its own program order, and a rotation pointer
    restores global stream order at emit time.

    Presents the Retirer surface DEFER._stream_loop drives: add /
    collect / flush / discard / ready_count.
    """

    def __init__(self, num_replicas: int, depth: int, sync: Any = hard_sync):
        # Per-replica depth: total in-flight stays within the caller's
        # max_inflight bound — but a depth-1 Retirer blocks on its
        # windowed barrier at every add(), so warn that the bank
        # degrades to synchronous per-item dispatch.
        per = max(1, depth // num_replicas)
        if per < 2:
            log.warning(
                "max_inflight=%d gives %d replicas a per-replica window "
                "of 1: dispatch degrades to synchronous per-item "
                "round-trips; set max_inflight >= %d to restore "
                "pipelining",
                depth,
                num_replicas,
                2 * num_replicas,
            )
        self.retirers = [Retirer(per, sync) for _ in range(num_replicas)]
        self._ready: list[list[Any]] = [[] for _ in range(num_replicas)]
        self._add_at = 0
        self._emit_at = 0

    def _drain(self) -> list[Any]:
        out = []
        n = len(self.retirers)
        while True:
            r = self._emit_at % n
            if not self._ready[r]:
                break
            out.append(self._ready[r].pop(0))
            self._emit_at += 1
        return out

    def add(self, item: Any) -> list[Any]:
        r = self._add_at % len(self.retirers)
        self._add_at += 1
        self._ready[r].extend(self.retirers[r].add(item))
        return self._drain()

    def collect(self) -> list[Any]:
        for r, ret in enumerate(self.retirers):
            self._ready[r].extend(ret.collect())
        return self._drain()

    def flush(self) -> list[Any]:
        for r, ret in enumerate(self.retirers):
            self._ready[r].extend(ret.flush())
        return self._drain()

    def discard(self) -> int:
        """Drop everything not yet emitted (in-flight and stuck-behind-
        a-gap results); returns the count, mirroring Retirer.discard."""
        n = sum(ret.discard() for ret in self.retirers)
        n += sum(len(p) for p in self._ready)
        self._ready = [[] for _ in self.retirers]
        # Re-align rotation: the stream restarts cleanly after a
        # re-dispatch with no half-emitted round.
        self._add_at = 0
        self._emit_at = 0
        return n

    def ready_count(self) -> int:
        return sum(ret.ready_count() for ret in self.retirers) + sum(
            len(p) for p in self._ready
        )

    def __len__(self) -> int:
        return sum(len(ret) for ret in self.retirers)


class ShardedInference(StreamMeasure):
    """The whole graph on each device of an explicit list, the batch
    split into one shard per listed device (a device listed twice takes
    two shards through one placed copy of the params); or over a mesh's
    `data_axis` (module docstring). `devices=None` is every CUDA device,
    and raises without one."""

    def __init__(
        self,
        graph: Graph,
        params: GraphParams,
        devices: Sequence[torch.device] | Mesh | None = None,
        config: DeferConfig | None = None,
        *,
        data_axis: str = "data",
    ):
        self.config = config or DeferConfig()
        self.mesh = None
        self.data_axis = data_axis
        if isinstance(devices, Mesh):
            if devices.distributed:
                self.mesh = devices
                devices = [devices.local_device]
            else:
                devices = devices.axis_devices(data_axis)
        elif devices is None:
            devices = cuda_devices()
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedInference needs at least one device")
        self.graph = graph
        # Place params once per distinct device (the analogue of the
        # reference's one-time weight dispatch, src/dispatcher.py:47-63).
        self._stages: dict[torch.device, Stage] = {}
        for d in self.devices:
            if d not in self._stages:
                self._stages[d] = Stage(graph, params, d, self.config)

    @property
    def num_shards(self) -> int:
        if self.mesh is not None:
            return self.mesh.shape[self.data_axis]
        return len(self.devices)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to one batch (async on CUDA). The leading dim must
        divide by the number of shards — pad at the driver if it
        doesn't."""
        if self.mesh is not None:
            return self._over_ranks(x)
        if x.shape[0] % self.num_shards:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by {self.num_shards} "
                f"shards — pad the batch or change the device list"
            )
        home = self.devices[0]
        outs = []
        with torch.inference_mode():
            for d, shard in zip(self.devices, x.chunk(self.num_shards)):
                y = self._stages[d](shard.to(d, non_blocking=True))
                outs.append(y.to(home, non_blocking=True))
        return torch.cat(outs)

    def _over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's call on the whole batch: this data index's shard
        on this rank's device, the shards all-gathered in order on the
        data-axis line."""
        n = self.num_shards
        if x.shape[0] % n:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by {n} data shards — "
                "pad the batch or resize the mesh"
            )
        dev = self.devices[0]
        shard = x.chunk(n)[self.mesh.coords[self.data_axis]]
        with torch.inference_mode():
            y = self._stages[dev](shard.to(dev, non_blocking=True))
            return collectives.gather_dim(
                y.contiguous(), self.mesh.group(self.data_axis), n, 0)

    def submit(self, x: torch.Tensor) -> Pending:
        return Pending(self(x))

    def stream(
        self, inputs: Iterable[Any], *, max_inflight: int | None = None
    ) -> Iterator[torch.Tensor]:
        retirer = Retirer(max_inflight or self.config.max_inflight)
        for x in inputs:
            for done in retirer.add(self.submit(x)):
                yield done.value
        for done in retirer.flush():
            yield done.value


class ReplicatedPipeline(StreamMeasure):
    """R pipeline replicas over R x S devices, fed round-robin.

    Output order is the input order: replica r gets microbatches
    r, r+R, r+2R, ... and each replica is internally in-order, so
    yielding one result per replica in dispatch rotation restores the
    global stream order without any reordering buffer.
    """

    def __init__(
        self,
        stages: Sequence[Graph | StageGraph],
        params: GraphParams,
        devices: Sequence[torch.device] | Mesh,
        config: DeferConfig | None = None,
        *,
        num_replicas: int | None = None,
    ):
        self.config = config or DeferConfig()
        n_stages = len(stages)
        if num_replicas is None:
            num_replicas = max(1, len(devices) // n_stages)
        if num_replicas * n_stages > len(devices):
            raise ValueError(
                f"{num_replicas} replicas x {n_stages} stages needs "
                f"{num_replicas * n_stages} devices, got {len(devices)}"
            )
        self.pipes = [
            Pipeline(
                stages,
                params,
                devices[r * n_stages : (r + 1) * n_stages],
                self.config,
            )
            for r in range(num_replicas)
        ]
        self._next_replica = 0
        log.info(
            "replicated pipeline: %d replicas x %d stages over %d devices",
            num_replicas,
            n_stages,
            num_replicas * n_stages,
        )

    @property
    def num_replicas(self) -> int:
        return len(self.pipes)

    @property
    def num_stages(self) -> int:
        return self.pipes[0].num_stages

    def __call__(self, x: Any) -> Any:
        # Single-shot call: replica 0 (no fan-out to coordinate).
        return self.pipes[0](x)

    def submit(self, x: Any) -> Pending:
        """Round-robin one microbatch to the next replica. Callers that
        submit through here (DEFER._stream_loop) retire results in
        dispatch order, which IS global stream order."""
        r = self._next_replica
        self._next_replica = (r + 1) % len(self.pipes)
        return self.pipes[r].submit(x)

    def make_retirer(
        self, depth: int, sync: Any = hard_sync
    ) -> ReplicaRetirer:
        """The retirer matching round-robin `submit` order (one Retirer
        per replica; see ReplicaRetirer). Stream loops that submit
        through this runtime MUST retire through this, or a wedged
        replica's unfinished work gets retired on a sibling's barrier.

        Resets the submit rotation so the retirer's internal rotation
        starts aligned; every failure path re-aligns via
        ReplicaRetirer.discard() + a fresh pipeline."""
        self._next_replica = 0
        return ReplicaRetirer(len(self.pipes), depth, sync)

    def stream(
        self, inputs: Iterable[Any], *, max_inflight: int | None = None
    ) -> Iterator[Any]:
        """Round-robin dispatch with a per-replica in-flight cap."""
        depth = max_inflight or self.config.max_inflight
        retirer = self.make_retirer(depth * len(self.pipes))
        for x in inputs:
            for done in retirer.add(self.submit(x)):
                yield done.value
        for done in retirer.flush():
            yield done.value

    def warmup(self, x: Any) -> Any:
        # Every replica is its own placement — warm them all
        # (StreamMeasure.warmup would only run replica 0).
        outs = [p(x) for p in self.pipes]
        hard_sync(*outs)
        return outs[0]

    def probe_stage_latencies(
        self, x: Any, iters: int = 10
    ) -> list[dict[str, Any]]:
        """Per-stage latencies of replica 0 (replicas are identical
        programs on identical hardware)."""
        return self.pipes[0].probe_stage_latencies(x, iters=iters)
