"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one cell, configuration, traffic mix, traffic
kind or per-layer metric is found by its name:

    benchmark/workloads/<cell>.json    config, chips, cuts, traffic, the
                                       program's DeferConfig, the check
    benchmark/configs/<config>.json    sizes, dtype, output, weight init
    benchmark/traffic/<mix>.json       the mix's parameters and its kind
    benchmark/traffic/<kind>.py        the generator that drives the mix
    benchmark/metrics/<metric>.py      a per-layer reader: read(ctx)
    benchmark/reference/<config>.py    plain float32 PyTorch model
    benchmark/counts/<config>.py       frozen FLOPs and kernel counts

The system under test is `defer_tpu_torch.DEFER.run_defer`, driven as a
user drives it: a feeder thread puts items on its input queue (the
traffic kind's), `run_defer` runs in its own thread, and a consumer
thread takes results off its output queue. A result counts when the
consumer takes it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import queue
import random
import sys
import threading
import time
from typing import Any, Callable

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PROGRAM = "defer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "defer_tpu")
RESULT_WAIT_S = 60.0  # how long past the window a due result may come
NOTHING_CHECKED = 1e9  # the error read when no output was sampled

clock = time.perf_counter


# -- finding the parts by name ----------------------------------------------


def load_json(*parts: str) -> Any:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    mod_name = f"benchmark.{kind}.{name.replace('.', '__')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict
    mix: dict
    kind: Any  # traffic/<kind>.py
    reference: Any
    counts: Any


def load_cell(name: str, mix_overrides: dict | None = None) -> Cell:
    spec = load_json("workloads", f"{name}.json")
    config = load_json("configs", f"{spec['config']}.json")
    mix = dict(load_json("traffic", f"{spec['traffic']}.json"))
    mix.update(mix_overrides or {})
    return Cell(
        name=name, spec=spec, config=config, mix=mix,
        kind=load_module("traffic", mix["kind"]),
        reference=load_module("reference", spec["config"]),
        counts=load_module("counts", spec["config"]),
    )


def per_layer_metrics(cell: str, bench: dict | None = None) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list that move an end-to-end metric the cell
    reports."""
    bench = bench or benchmark_spec()
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def end_to_end_metrics(cell: str, bench: dict | None = None) -> list[dict]:
    bench = bench or benchmark_spec()
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (`defer_tpu_torch` is not `defer_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the run's moving parts ---------------------------------------------------


class Consumer(threading.Thread):
    """Takes results off the output queue and stamps each with the
    host clock. Keeps a sample of the results inside the window for the
    check: a reservoir of `sample_size`, drawn from the run's seed, over
    the results `in_window(index, time)` accepts."""

    def __init__(self, out_q: queue.Queue, served: threading.Event,
                 sample_size: int, sample_seed: int):
        super().__init__(name="bench-consumer", daemon=True)
        self.out_q = out_q
        self.served = served
        self.times: list[float] = []
        self.sample_size = sample_size
        self._rng = random.Random(sample_seed)
        self._seen = 0
        self.sample: list[tuple[int, Any]] = []
        self.in_window: Callable[[int, float], bool] | None = None
        self._open_next = False
        self.window_open = threading.Event()
        self.t0 = None
        self.seconds = None
        self.arrived = threading.Condition()

    def open_window(self, seconds: float) -> None:
        """The next result taken opens a window of `seconds`: results
        taken after it, up to `seconds` later, are inside."""
        self.seconds = seconds
        self._open_next = True

    def run(self) -> None:
        get, times = self.out_q.get, self.times
        while True:
            try:
                item = get(timeout=0.05)
            except queue.Empty:
                if self.served.is_set() and self.out_q.empty():
                    break
                continue
            t = clock()
            idx = len(times)
            times.append(t)
            if self._open_next:
                self._open_next = False
                self.t0 = t
                t1 = t + self.seconds
                self.in_window = lambda i, ti, t0=t, t1=t1: t0 < ti <= t1
                self.window_open.set()
            elif self.in_window is not None and self.in_window(idx, t):
                self._keep(idx, item)
            with self.arrived:
                self.arrived.notify_all()

    def _keep(self, idx: int, item: Any) -> None:
        self._seen += 1
        if len(self.sample) < self.sample_size:
            self.sample.append((idx, item))
            return
        j = self._rng.randrange(self._seen)
        if j < self.sample_size:
            self.sample[j] = (idx, item)

    def wait_count(self, n: int, timeout: float) -> bool:
        deadline = clock() + timeout
        with self.arrived:
            while len(self.times) < n:
                left = deadline - clock()
                if left <= 0 or self.served.is_set():
                    return len(self.times) >= n
                self.arrived.wait(min(left, 0.1))
        return True


class Runtime:
    """What a traffic kind drives: the queues, the consumer, the clock,
    the run's stop switch and the traced stretch."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 devices: list, sample_seed: int):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.mix = cell.mix
        self.devices = devices
        self.in_q: queue.Queue = queue.Queue(maxsize=int(cell.mix.get("queue_depth", 0)))
        self.out_q: queue.Queue = queue.Queue()
        self.served = threading.Event()
        self.stop = threading.Event()
        self.error: BaseException | None = None
        self.consumer = Consumer(self.out_q, self.served,
                                 int(cell.spec["check"]["sample"]), sample_seed)
        self.tracer = None
        self.registry_at: dict[str, Any] = {}

    def put(self, item: Any) -> bool:
        """Put on the input queue, giving up once the run stops or the
        program has ended; True if it went on."""
        while not self.stop.is_set() and not self.served.is_set():
            try:
                self.in_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def end_input(self) -> None:
        """The sentinel that ends `run_defer`'s loop."""
        while not self.served.is_set():
            try:
                self.in_q.put(None, timeout=0.1)
                return
            except queue.Full:
                continue

    def hold_window(self, t0: float, t1: float) -> None:
        """Called by the traffic kind, from the main thread, once the
        window's bounds are known; returns at its end, or in a traced
        run after the profiled stretch that follows it, with the traffic
        still flowing. Snapshots the program's counters at both ends of
        each."""
        self.registry_at["t0"] = registry_snapshot()
        self.sleep_until(t1)
        self.registry_at["t1"] = registry_snapshot()
        if self.trace:
            from benchmark import trace as tracing

            self.tracer = tracing.Stretch(
                self.mix, [d.index for d in self.devices if d.type == "cuda"])
            self.tracer.hold(lambda s: self.sleep_until(clock() + s),
                             registry_snapshot, self.registry_at)

    def sleep_until(self, t: float) -> None:
        while True:
            left = t - clock()
            if left <= 0 or self.served.is_set():
                return
            time.sleep(min(left, 0.05))


def registry_snapshot() -> dict:
    from defer_tpu_torch.obs.metrics import get_registry

    return get_registry().to_dict()


@dataclasses.dataclass
class Outcome:
    """What a traffic kind reports of its window."""

    metrics: dict[str, float]  # end-to-end metric name -> value
    attempted: int
    failed: int
    t0: float
    t1: float
    # (input entry index, the program's output for that entry)
    checked: list[tuple[int, Any]]
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


# -- the run ------------------------------------------------------------------


def run_cell(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    devices: list,
    t_start: float,
) -> dict:
    """Set up, drive the window, check; the result as a dict in the
    order the result line prints it."""
    import torch

    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.models import get_model

    from benchmark import weights

    cfg = cell.config
    dtype = getattr(torch, cfg["compute_dtype"])
    specs = cell.reference.param_specs(cfg)
    w = weights.draw(specs, cfg["init"], seed, devices[0], dtype)
    model = get_model(cfg["program_model"])
    rt = Runtime(cell, seed, seconds, trace, devices,
                 weights.sub_seed(seed, "sample"))
    state = cell.kind.prepare(rt, model)
    defer = DEFER(devices=devices, config=DeferConfig(
        compute_dtype=dtype, **cell.spec.get("defer_config", {})))
    cuts = list(cell.spec.get("cuts", [])) or None

    def serve():
        try:
            defer.run_defer(model, cuts, rt.in_q, rt.out_q,
                            params=weights.as_tree(w))
        except BaseException as e:  # noqa: BLE001 — reported in the result
            rt.error = e
        finally:
            rt.served.set()

    server = threading.Thread(target=serve, name="bench-run-defer", daemon=True)
    server.start()
    rt.consumer.start()
    try:
        window = cell.kind.drive(rt, state)
    finally:
        rt.stop.set()
        rt.end_input()
        server.join(timeout=RESULT_WAIT_S + 60)
        rt.consumer.join(timeout=30)
    if rt.error is not None:
        raise RuntimeError(f"run_defer failed: {rt.error!r}") from rt.error
    if server.is_alive():
        raise RuntimeError("run_defer did not end after its input did")
    outcome = cell.kind.report(rt, state, window)
    if rt.tracer is not None and rt.tracer.wall_s:
        # The stretch's own pace, beside the window's: the profiler's cost.
        a, b = rt.tracer.t0, rt.tracer.t0 + rt.tracer.wall_s
        done = sum(1 for t in rt.consumer.times if a < t <= b)
        outcome.extra["stretch_images_per_s"] = (
            done * cell.kind.images_per_result(cell.mix) / rt.tracer.wall_s)

    on_card = devices[0].type == "cuda"
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if on_card else 0)
    device = {
        "platform": "gpu" if on_card else devices[0].type,
        "kind": torch.cuda.get_device_name(devices[0]) if on_card else "cpu",
        "count": len(devices),
        "memory_peak_bytes": int(peak),
    }
    traced = rt.tracer.result(torch) if rt.tracer is not None else None

    # The program's state goes before the reference runs.
    del defer, w, state, server
    rt.consumer.sample = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    rows_checked = sum(int(o.shape[0]) for _, o in outcome.checked)
    checks = check(cell, seed, outcome.checked, devices[0])
    checks["results_missing"] = {"value": float(outcome.failed), "limit": 0.0}
    outcome.checked = []
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result: dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
    }
    if trace:
        from benchmark import trace as tracing

        ctx = tracing.Context(cell=cell, outcome=outcome, traced=traced,
                              registry=rt.registry_at, device=device)
        metrics = {}
        for m in per_layer_metrics(cell.name):
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        device.update(busy_s=traced.busy_s if traced else 0.0,
                      window_s=traced.window_s if traced else 0.0)
        result["device"] = device
        if traced is not None:
            result["breakdown"] = traced.breakdown
    else:
        e2e = dict(outcome.metrics, setup_s=outcome.t0 - t_start)
        result["metrics"] = {
            m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
            for m in end_to_end_metrics(cell.name) if m["name"] in e2e
        }
        result["device"] = device
    if outcome.extra:
        result["traffic"] = outcome.extra
    result["rows_checked"] = rows_checked
    result["check"] = checks
    return result


def check(cell: Cell, seed: int, checked: list[tuple[int, Any]],
          device) -> dict[str, dict[str, float]]:
    """Each sampled output against the reference on inputs and weights
    drawn anew from the seed, in float32 with TF32 off, a block of rows
    at a time. Returns the numbers compared, each with its limit."""
    import torch

    from benchmark import compare, weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, lim = cell.config, cell.spec["check"]
    ref = cell.reference
    w = weights.draw(ref.param_specs(cfg), cfg["init"], seed, device,
                     getattr(torch, cfg["compute_dtype"]))
    entries = weights.input_entries(seed, cell.kind.entries(cell.mix),
                                    cell.kind.entry_shape(cell.mix), device)
    block = int(lim.get("block", 32))
    needed = sorted({j for j, _ in checked})

    def reference(j):
        x = entries[j]
        with torch.no_grad():
            return torch.cat([ref.forward(cfg, w, x[a:a + block])
                              for a in range(0, x.shape[0], block)])

    expected = {j: reference(j) for j in needed}
    # Nothing to check reads as a failure, not as a pass.
    worst = NOTHING_CHECKED if not checked else 0.0
    for j, out in checked:
        errs = compare.row_errors(out.to(device), expected[j], cfg["output"])
        worst = max(worst, float(errs.max()))
    return {"row_rel_err_max": {"value": worst, "limit": float(lim["limit"])}}


# -- the command ----------------------------------------------------------------


def main(workload: str, seed: int, seconds: float, trace: bool, *,
         t_start: float) -> int:
    try:
        cell = load_cell(workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: cannot load cell {workload!r}: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program {PROGRAM} is not here", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = run_cell(cell, seed, seconds, trace, devices, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}; the benchmark measures "
              f"{PROGRAM} alone", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
