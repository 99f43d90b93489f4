"""Device-pinned pipeline runtime for heterogeneous stage chains
(counterpart of `defer_tpu/parallel/pipeline.py`).

  * each stage is an `nn.Module` holding its param slice on its own
    device, placed once at construction;
  * an activation moves with `.to(device, non_blocking=True)` only when
    the next stage lives on another device;
  * PyTorch's asynchronous CUDA launches are the pipelining engine: the
    host enqueues microbatch t on stage 0 while the card still works on
    earlier ones.

Backpressure is a cap on in-flight microbatches, enforced through
`Retirer` (utils/sync.py): one event barrier per window, never per item.

Each stage call is timed on the host in two phases, `place` (the input's
move to the stage's device: the HtoD copy's enqueue for stage 0, the
card-to-card hop after it) and `launch` (enqueueing the stage's
kernels), into `defer_stage_host_seconds_total{stage,phase}`, and, while
span recording is on, as a `defer:stage<i>` span with the two as
children (utils/profiling.py).
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Iterator, Sequence

import torch
from torch import nn

from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.graph.ir import Graph, GraphParams
from defer_tpu_torch.graph.partition import StageGraph, stage_params
from defer_tpu_torch.obs.metrics import get_registry
from defer_tpu_torch.utils.profiling import SPANS, clock
from defer_tpu_torch.utils.sync import Pending, Retirer, hard_sync


def _tree_map(fn, x: Any) -> Any:
    if isinstance(x, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in x)
    return fn(x)


def resolve_device(device: Any) -> torch.device:
    """torch.device with an explicit index for CUDA ("cuda" -> the
    current CUDA device), so residency checks compare like with like."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def cast_params_to_storage(params: Any, config: DeferConfig) -> Any:
    """Cast floating-point param leaves to config.storage_dtype once at
    placement time — casting inside every stage call would cost an extra
    device-memory pass per microbatch."""
    sd = config.storage_dtype
    if not sd.is_floating_point:
        return params
    return {
        name: {
            k: v.to(sd) if v.is_floating_point() else v
            for k, v in node.items()
        }
        for name, node in params.items()
    }


def place_params(
    graph: Graph | StageGraph, params: GraphParams, config: DeferConfig
) -> dict:
    """A stage's params as it holds them: cast to the storage dtype, then
    each op's placement form (ops/registry.py `place`): conv kernels
    stored O,H,W,I behind their HWIO shape, batch norms folded to one
    scale and shift in the compute dtype. Done once, at construction."""
    from defer_tpu_torch.ops import get_op

    ops = {n.name: n for n in graph.nodes}
    return {
        name: get_op(ops[name].op).place(
            node, ops[name].attrs, config.compute_dtype
        )
        for name, node in cast_params_to_storage(params, config).items()
    }


def probe_latency(fn: Any, *args: Any, iters: int = 10) -> dict[str, Any]:
    """Synchronous latency sample for one stage callable — the timing
    core `Pipeline.probe_stage_latencies` reports per stage. Runs one
    untimed call first (warm-up), then `iters` synced calls for the p50,
    then one amortized window (enqueue `iters`, one barrier)."""
    hard_sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        hard_sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    hard_sync(outs[-1])
    amortized = (time.perf_counter() - t0) / iters
    return {
        "p50_s": times[len(times) // 2],
        "p99_s": times[int(len(times) * 0.99)] if len(times) >= 100 else None,
        "max_s": times[-1],
        "min_s": times[0],
        "amortized_s": amortized,
    }


def balance_stage_cuts(costs: Sequence[float], num_stages: int) -> list[int]:
    """Contiguous min-max partition of per-layer costs into `num_stages`
    stages: the stage START indices (cuts[0] == 0), chosen so that the
    most expensive stage is as cheap as possible. Exact O(L^2 * S)
    dynamic program; every stage is non-empty, so num_stages must not
    exceed len(costs)."""
    L = len(costs)
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_stages > L:
        raise ValueError(
            f"cannot split {L} layers into {num_stages} non-empty "
            "stages"
        )
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))
    # best[s][j]: the least max-stage cost splitting costs[:j] into s
    # stages; cut[s][j]: the start of the last stage in that optimum.
    inf = float("inf")
    best = [[inf] * (L + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (L + 1) for _ in range(num_stages + 1)]
    best[0][0] = 0.0
    for s in range(1, num_stages + 1):
        for j in range(s, L + 1):
            for i in range(s - 1, j):
                cand = max(best[s - 1][i], prefix[j] - prefix[i])
                if cand < best[s][j]:
                    best[s][j] = cand
                    cut[s][j] = i
    starts: list[int] = []
    j = L
    for s in range(num_stages, 0, -1):
        j = cut[s][j]
        starts.append(j)
    starts.reverse()
    return starts


class StreamMeasure:
    """Shared warmup/throughput for anything with __call__ + stream —
    one definition of the measurement protocol."""

    def warmup(self, x: Any) -> Any:
        """One untimed call (kernel builds, allocator warm-up) before
        any timing."""
        out = self(x)
        hard_sync(out)
        return out

    def throughput(
        self, x: Any, num_microbatches: int = 256
    ) -> dict[str, float]:
        self.warmup(x)
        t0 = time.perf_counter()
        n = 0
        last = None
        for out in self.stream(x for _ in range(num_microbatches)):
            last = out
            n += 1
        # Stream order: the last output retires after every earlier one.
        hard_sync(last)
        dt = time.perf_counter() - t0
        batch = int(x.shape[0]) if hasattr(x, "shape") and x.ndim > 0 else 1
        return {
            "microbatches": n,
            "seconds": dt,
            "microbatches_per_sec": n / dt,
            "items_per_sec": n * batch / dt,
        }


class Stage(nn.Module):
    """One pipeline stage: its graph and its param slice, held on
    `device` in the storage dtype and each op's placement form."""

    def __init__(
        self,
        graph: Graph | StageGraph,
        params: GraphParams,
        device: torch.device,
        config: DeferConfig,
    ):
        super().__init__()
        self.graph = graph
        self.device = resolve_device(device)
        self.compute_dtype = config.compute_dtype
        placed = place_params(graph, stage_params(params, graph), config)
        self.params = nn.ModuleDict(
            {
                name: nn.ParameterDict(
                    {
                        k: nn.Parameter(
                            v.to(self.device), requires_grad=False
                        )
                        for k, v in node.items()
                    }
                )
                for name, node in placed.items()
            }
        )
        # Plain-dict view of the same Parameter objects, for the ops.
        self._tree = {
            name: dict(node.items()) for name, node in self.params.items()
        }

    def forward(self, x: Any) -> Any:
        # Integer inputs (token ids) keep their dtype; x may be a tuple
        # (multi-tensor boundary).
        x = _tree_map(
            lambda a: a.to(self.compute_dtype) if a.is_floating_point() else a,
            x,
        )
        return self.graph.apply(self._tree, x)


class Pipeline(StreamMeasure):
    """A chain of stages, each pinned to one device."""

    def __init__(
        self,
        stages: Sequence[Graph | StageGraph],
        params: GraphParams,
        devices: Sequence[torch.device],
        config: DeferConfig | None = None,
    ):
        if len(devices) != len(stages):
            raise ValueError(
                f"{len(stages)} stages need {len(stages)} devices, "
                f"got {len(devices)}"
            )
        self.config = config or DeferConfig()
        self.stages = list(stages)
        self.devices = [resolve_device(d) for d in devices]
        self.stage_modules = [
            Stage(stage, params, dev, self.config)
            for stage, dev in zip(self.stages, self.devices)
        ]
        # One shared counter across every Pipeline: total microbatches
        # dispatched process-wide.
        reg = get_registry()
        self._obs_microbatches = reg.counter(
            "defer_pipeline_microbatches_total",
            "Microbatches dispatched through a stage chain",
        )
        # Per stage: its span's name and its place and launch counters.
        self._stage_obs = [
            (f"defer:stage{i}", *(
                reg.counter(
                    "defer_stage_host_seconds_total",
                    "Host seconds a stage call spent placing its input "
                    "and enqueueing its kernels",
                    {"stage": str(i), "phase": phase},
                )
                for phase in ("place", "launch")
            ))
            for i in range(len(self.stages))
        ]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    # -- execution -------------------------------------------------------

    @staticmethod
    def _place(x: Any, dev: torch.device) -> Any:
        """Move to `dev` only when a tensor is elsewhere; tree-aware for
        multi-tensor boundary tuples."""
        return _tree_map(
            lambda a: a
            if isinstance(a, torch.Tensor) and a.device == dev
            else torch.as_tensor(a).to(dev, non_blocking=True),
            x,
        )

    def __call__(self, x: Any) -> Any:
        """Push one microbatch through the chain (async on CUDA: the
        returned tensor is a future; `hard_sync` waits for it)."""
        self._obs_microbatches.inc()
        with torch.inference_mode():
            h = x
            for stage, (span, placed, launched) in zip(
                self.stage_modules, self._stage_obs
            ):
                t0 = clock()
                h = self._place(h, stage.device)
                t1 = clock()
                h = stage(h)
                t2 = clock()
                placed.inc((t1 - t0) * 1e-9)
                launched.inc((t2 - t1) * 1e-9)
                if SPANS.on:
                    SPANS.record(span, t0, t2, (("defer:place", t0, t1),
                                                ("defer:launch", t1, t2)))
        return h

    def submit(self, x: Any) -> Pending:
        """Uniform submission point for stream loops: the output plus
        the event recorded right after its last stage."""
        return Pending(self(x))

    def stream(
        self,
        inputs: Iterable[Any],
        *,
        max_inflight: int | None = None,
    ) -> Iterator[Any]:
        """Stream microbatches through the pipeline with bounded
        in-flight depth; yields outputs in order."""
        depth = max_inflight or self.config.max_inflight
        retirer = Retirer(depth)
        for x in inputs:
            # Backpressure: Retirer emits the known-ready prefix for
            # free and, at depth, takes one batched barrier on the
            # middle of the window — never waits per item.
            for done in retirer.add(self.submit(x)):
                yield done.value
        for done in retirer.flush():
            yield done.value

    # -- measurement (warmup/throughput come from StreamMeasure) ---------

    def probe_stage_latencies(
        self, x: Any, iters: int = 10
    ) -> list[dict[str, Any]]:
        """Per-stage latency in seconds, measured synchronously. Run
        outside the streaming loop so probing doesn't break overlap.
        `p99_s` is only reported when iters >= 100 — below that the 99th
        percentile of the sample IS its max."""
        results = []
        with torch.inference_mode():
            h = x
            for i, stage in enumerate(self.stage_modules):
                h = self._place(h, stage.device)
                hard_sync(h)
                sample = probe_latency(stage, h, iters=iters)
                results.append(
                    {"stage": i, "device": str(stage.device), **sample}
                )
                # Cold path: registry lookup per probe is fine here.
                reg = get_registry()
                labels = {"stage": str(i)}
                reg.gauge(
                    "defer_stage_amortized_seconds",
                    "Amortized per-microbatch stage time (last probe)",
                    labels,
                ).set(sample["amortized_s"])
                reg.gauge(
                    "defer_stage_p50_seconds",
                    "Synchronous p50 stage latency (last probe)",
                    labels,
                ).set(sample["p50_s"])
                h = stage(h)
        return results
