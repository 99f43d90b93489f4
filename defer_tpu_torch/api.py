"""The DEFER facade on PyTorch (counterpart of `defer_tpu/api.py`).

    defer = DEFER()                          # every CUDA device
    defer.run_defer(model, ["encoder_5_out"], input_q, output_q)

`run_defer` keeps the blocking, queue-driven contract: partition at the
named cuts, place each stage's params on its device, then stream queue
items through the stage chain until a None/STOP sentinel or `stop()`.
With no `devices=` everything runs on CUDA, and a missing card is an
error: the port never drops to the CPU on its own. Tests ask for the CPU
with `devices=[torch.device("cpu")]`.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Sequence

import torch

from defer_tpu_torch.config import DeferConfig, normalize_cuts
from defer_tpu_torch.graph.ir import Graph, GraphParams
from defer_tpu_torch.graph.partition import partition
from defer_tpu_torch.models import Model
from defer_tpu_torch.obs.metrics import get_registry
from defer_tpu_torch.parallel.data_parallel import ReplicatedPipeline
from defer_tpu_torch.parallel.mesh import cuda_devices, pipeline_devices
from defer_tpu_torch.parallel.pipeline import Pipeline, resolve_device
from defer_tpu_torch.runtime.batching import split_output
from defer_tpu_torch.runtime.host_io import STOP, ProgressMonitor
from defer_tpu_torch.utils import profiling
from defer_tpu_torch.utils.logging import get_logger
from defer_tpu_torch.utils.sync import (
    Pending,
    Retirer,
    hard_sync,
    hard_sync_timeout,
)

log = get_logger(__name__)


class DEFER:
    """Pipeline-parallel inference orchestrator.

    `devices`: the devices stages are placed on, round-robin (default:
    every CUDA device; raises when there is none).
    """

    def __init__(
        self,
        devices: Sequence[torch.device] | None = None,
        config: DeferConfig | None = None,
    ):
        self.devices = (
            [resolve_device(d) for d in devices]
            if devices is not None
            else cuda_devices()
        )
        self.config = config or DeferConfig()
        self._stop = threading.Event()
        self.last_pipeline: Pipeline | None = None
        # Filled by run_defer when config.probe_every > 0.
        self.last_stage_latencies: list[dict[str, float]] | None = None

    # -- construction ----------------------------------------------------

    def build_pipeline(
        self,
        model: Model | Graph | str,
        partition_layers: Sequence[str | Sequence[str]] | str | None,
        *,
        params: GraphParams | None = None,
        rng: torch.Generator | None = None,
        batch_size: int = 1,
        replicas: int = 1,
    ) -> tuple[Pipeline | ReplicatedPipeline, Any]:
        """Partition + place; returns (pipeline, example_input).

        Cut points become stage graphs, and each stage's param slice is
        cast to the storage dtype and moved to its device once.
        partition_layers="auto" picks FLOPs-balanced boundaries, one
        stage per device slot (`devices=[d] * 4` makes four stages on d).
        Without `params`, a Model is initialised from `rng` (default: a
        CPU generator seeded with 0), in float32. `model` may be a Keras
        `model.to_json()` string, the reference's wire format (reference
        src/dispatcher.py:52).

        replicas > 1 composes data parallelism with the stage chain:
        the whole pipeline is replicated that many times (over
        replicas x stages device slots, round-robin over `devices`) and
        the stream fans microbatches across replicas round-robin, in
        order — the scaling axis the reference doesn't have.
        """
        auto = (
            isinstance(partition_layers, str) and partition_layers == "auto"
        )
        cuts = () if auto else normalize_cuts(partition_layers)
        if isinstance(model, str):
            from defer_tpu_torch.graph.keras_import import model_from_keras

            model, _ = model_from_keras(model)
        if isinstance(model, Model):
            graph = model.graph
            example = model.example_input(batch_size)
        else:
            graph = model
            example = None
        if params is None:
            if not isinstance(model, Model):
                raise ValueError("params required when passing a raw Graph")
            params = model.init(
                rng if rng is not None else torch.Generator().manual_seed(0),
                batch_size=batch_size,
                # Init in fp32; the stages cast to the storage dtype at
                # placement.
                param_dtype=torch.float32,
            )
        if auto:
            cuts = self._auto_cuts(model, graph, params, example, replicas)
        stages = partition(graph, cuts) if cuts else [graph]
        pipe = self._compile(stages, params, replicas, None)
        self.last_pipeline = pipe
        # Retained for elastic re-dispatch after a stage failure.
        self._build_state = (stages, params, replicas)
        return pipe, example

    def _auto_cuts(
        self,
        model: Model | Graph,
        graph: Graph,
        params: GraphParams,
        example: Any,
        replicas: int,
    ) -> tuple:
        """FLOPs-balanced cuts, one stage per device slot of a replica
        (capped at the candidates plus one): the model's cut candidates,
        or every chain boundary of the graph where it has none."""
        from defer_tpu_torch.graph.partition import chain_boundaries
        from defer_tpu_torch.utils.flops import balanced_cuts

        if example is None:
            raise ValueError(
                'partition_layers="auto" needs a Model (a raw Graph '
                "has no input shape to balance FLOPs against)"
            )
        cands = (
            model.cut_candidates
            if isinstance(model, Model) and model.cut_candidates
            else chain_boundaries(graph)
        )
        # Each replica needs its own stage slots: claiming every device
        # for one replica's stages would wrap further replicas onto the
        # same slots.
        n_stages = min(
            max(1, len(self.devices) // max(1, replicas)), len(cands) + 1
        )
        cuts = tuple(
            balanced_cuts(
                graph,
                params,
                tuple(example.shape),
                n_stages,
                cands,
                input_dtype=example.dtype,
            )
        )
        log.info("auto cuts (%d stages): %s", n_stages, cuts)
        return cuts

    def _compile(
        self,
        stages: Sequence[Any],
        params: GraphParams,
        replicas: int,
        device_pool: Sequence[torch.device] | None,
    ) -> Pipeline | ReplicatedPipeline:
        pool = device_pool if device_pool is not None else self.devices
        if replicas > 1:
            if len(stages) * replicas > len(pool):
                log.warning(
                    "%d stages x %d replicas oversubscribes %d devices; "
                    "replicas will share devices",
                    len(stages),
                    replicas,
                    len(pool),
                )
            devices = pipeline_devices(len(stages) * replicas, pool)
            log.info(
                "built %d stages x %d replicas over devices %s",
                len(stages),
                replicas,
                devices,
            )
            return ReplicatedPipeline(
                stages, params, devices, self.config, num_replicas=replicas
            )
        devices = pipeline_devices(len(stages), pool)
        log.info("built %d stages over devices %s", len(stages), devices)
        return Pipeline(stages, params, devices, self.config)

    # -- elastic recovery -------------------------------------------------

    def _healthy_devices(self, timeout_s: float = 10.0) -> list[torch.device]:
        """Probe every candidate device with a tiny computation; a
        device that errors or misses the deadline is excluded from
        re-dispatch. All probes are enqueued first and then waited on
        under ONE shared deadline, so n hung devices cost one timeout,
        not n."""
        probes: list[tuple[torch.device, Pending]] = []
        healthy: list[torch.device] = []
        for d in self.devices:
            try:
                probes.append(
                    (d, Pending(torch.zeros((), device=d) + 1.0))
                )
            except Exception as e:  # noqa: BLE001 — exclusion is the point
                log.warning("device %s failed the health probe: %s", d, e)
        deadline = time.monotonic() + timeout_s
        for d, probe in probes:
            try:
                if hard_sync_timeout(
                    probe, max(0.0, deadline - time.monotonic())
                ):
                    healthy.append(d)
                else:
                    log.warning("device %s missed the health deadline", d)
            except Exception as e:  # noqa: BLE001 — exclusion is the point
                log.warning("device %s failed the health probe: %s", d, e)
        return healthy

    def _redispatch(
        self, cause: BaseException
    ) -> Pipeline | ReplicatedPipeline:
        """Rebuild the pipeline on the devices that still pass a health
        probe."""
        get_registry().counter(
            "defer_redispatch_total",
            "Elastic-recovery pipeline rebuilds after a device failure",
        ).inc()
        healthy = self._healthy_devices()
        if not healthy:
            raise RuntimeError(
                "re-dispatch impossible: no device passed the health probe"
            ) from cause
        stages, params, replicas = self._build_state
        log.warning(
            "re-dispatching %d stages (x%d replicas) onto %d healthy "
            "device(s) after: %s",
            len(stages),
            replicas,
            len(healthy),
            cause,
        )
        pipe = self._compile(stages, params, replicas, healthy)
        self.last_pipeline = pipe
        return pipe

    # -- streaming (the queue-in/queue-out contract) ---------------------

    def run_defer(
        self,
        model: Model | Graph | str,
        partition_layers: Sequence[str | Sequence[str]] | str | None,
        input_stream: "queue.Queue[Any]",
        output_stream: "queue.Queue[Any]",
        *,
        params: GraphParams | None = None,
        rng: torch.Generator | None = None,
        replicas: int = 1,
    ) -> None:
        """Blocking stream loop: consume input_stream, produce
        output_stream. Ends on a None/STOP sentinel or `stop()`."""
        self._stop.clear()
        pipe, _ = self.build_pipeline(
            model, partition_layers, params=params, rng=rng,
            replicas=replicas,
        )
        monitor = ProgressMonitor(self.config.collective_timeout_s)

        def watchdog_sync(item: Pending) -> None:
            # Event barrier with a deadline so a stuck stage trips the
            # watchdog instead of hanging forever. A barrier may cover
            # many microbatches; on timeout we only raise if the
            # completed prefix stopped growing — genuinely zero progress.
            last_ready = -1
            while not hard_sync_timeout(
                item, self.config.collective_timeout_s
            ):
                ready = retirer.ready_count()
                if ready <= last_ready:
                    raise TimeoutError(
                        f"pipeline made no progress for "
                        f"{self.config.collective_timeout_s:.0f}s — a stage "
                        "or transfer is stuck"
                    )
                last_ready = ready

        # Replicated runtimes supply their own retirer bank: the shared
        # windowed barrier is only sound within one stage chain (see
        # ReplicaRetirer in parallel/data_parallel.py).
        make = getattr(pipe, "make_retirer", None)
        retirer = (
            make(self.config.max_inflight, watchdog_sync)
            if make is not None
            else Retirer(self.config.max_inflight, sync=watchdog_sync)
        )

        # Dynamic batching: coalesce queue items into device batches
        # (runtime/batching.py) and split outputs back per item.
        # `splits` mirrors the dispatch FIFO: one sizes-list per
        # submitted batch, popped as its output retires.
        gatherer = None
        splits: "collections.deque[list[int]]" = collections.deque()
        if self.config.dynamic_batch_size > 1:
            from defer_tpu_torch.runtime.batching import BatchGatherer

            gatherer = BatchGatherer(
                self.config.dynamic_batch_size, self.config.batch_wait_s
            )

        obs_items = get_registry().counter(
            "defer_stream_items_total",
            "Results delivered to the output stream by run_defer",
        )

        def emit(items: Sequence[Pending]) -> None:
            for done in items:
                monitor.completed()
                if gatherer is None:
                    output_stream.put(done.value)
                    obs_items.inc()
                else:
                    for part in split_output(done.value, splits.popleft()):
                        output_stream.put(part)
                        obs_items.inc()

        # Unlike Pipeline.stream (pull-based), this loop must keep
        # emitting results while the input queue idles. Trace only a
        # bounded window of the (potentially unbounded) serving loop.
        tracer = profiling.WindowTrace()
        try:
            self._stream_loop(
                pipe, input_stream, emit, retirer, monitor, tracer,
                gatherer, splits,
            )
        finally:
            tracer.close()

    def _stream_loop(
        self, pipe, input_stream, emit, retirer, monitor, tracer,
        gatherer=None, splits=None,
    ):
        since_probe = 0
        retries_left = self.config.redispatch_attempts
        eos = False
        while not self._stop.is_set() and not eos:
            if gatherer is None:
                try:
                    item = input_stream.get(timeout=0.05)
                except queue.Empty:
                    emit(retirer.collect())
                    monitor.check()
                    continue
                if item is None or item is STOP:
                    break
                sizes = None
            else:
                item, sizes, eos = gatherer.gather(input_stream)
                if item is None:
                    if eos:
                        break
                    emit(retirer.collect())
                    monitor.check()
                    continue
            monitor.submitted()
            tracer.tick()
            while True:
                try:
                    if sizes is not None:
                        splits.append(sizes)
                    emit(retirer.add(pipe.submit(item)))
                    break
                except Exception as e:  # noqa: BLE001 — recovery below
                    if retries_left <= 0:
                        raise
                    retries_left -= 1
                    # Completed results (including the barrier-failure
                    # spill) are still valid — emit them before
                    # dropping what can no longer finish.
                    try:
                        emit(retirer.collect())
                    except Exception:  # noqa: BLE001 — dead buffers
                        pass
                    lost = retirer.discard()
                    if splits is not None:
                        # Everything un-emitted was just discarded; the
                        # retry below re-appends this batch's sizes.
                        splits.clear()
                    if lost:
                        log.warning(
                            "dropping %d in-flight results of the failed "
                            "pipeline",
                            lost,
                        )
                        monitor.dropped(lost)
                        get_registry().counter(
                            "defer_inflight_dropped_total",
                            "In-flight results lost to pipeline failures",
                        ).inc(lost)
                    pipe = self._redispatch(e)
            monitor.check()
            since_probe += 1
            if (
                self.config.probe_every
                and since_probe >= self.config.probe_every
            ):
                # Synchronous per-stage latency probe; drain first so it
                # doesn't interleave with (and distort) in-flight work.
                since_probe = 0
                emit(retirer.flush())
                self.last_stage_latencies = pipe.probe_stage_latencies(
                    item, iters=3
                )
        # After an explicit stop no new device work is submitted; what
        # is in flight is drained.
        emit(retirer.flush())

    def stop(self) -> None:
        self._stop.set()


def run_local_inference(
    model: Model,
    *,
    batch_size: int = 1,
    duration_s: float = 10.0,
    params: GraphParams | None = None,
    compute_dtype: Any = None,
    example: Any = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Single-device baseline: the whole model as one stage on one
    device (default: the current CUDA device), looped for `duration_s`
    — the denominator of every pipelining speedup. `example` supplies
    the looped input; default is the model's example input. The
    warm-up call's result comes back as "output"."""
    cfg = DeferConfig()
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    dev = resolve_device(device) if device is not None else cuda_devices()[0]
    if params is None:
        params = model.init(torch.Generator().manual_seed(0),
                            batch_size=batch_size)
    pipe = Pipeline([model.graph], params, [dev], cfg)
    # Place the example once — a host example would otherwise
    # re-transfer every iteration and skew the baseline.
    x = (
        torch.as_tensor(example)
        if example is not None
        else model.example_input(batch_size)
    ).to(dev)
    # Count what actually runs: the example's leading dim is the batch.
    batch_size = int(x.shape[0]) if x.ndim > 0 else 1
    output = pipe(x)
    hard_sync(output)  # warm-up

    count = 0
    t0 = time.perf_counter()
    retirer = Retirer(depth=16)
    while time.perf_counter() - t0 < duration_s:
        retirer.add(pipe.submit(x))
        count += 1
    # True completion barrier; stream order covers the rest.
    retirer.flush()
    dt = time.perf_counter() - t0
    return {
        "count": count,
        "seconds": dt,
        "batches_per_sec": count / dt,
        "items_per_sec": count * batch_size / dt,
        "output": output,
    }
