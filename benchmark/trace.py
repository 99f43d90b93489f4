"""The traced stretch of a `--trace 1` run and what the readers see of it.

A `--trace 1` run measures its window as a `--trace 0` run does, with no
profiler in the process. Once the window has closed, with the traffic
still flowing, `Stretch` profiles `trace_seconds` (3 by default) with
`torch.profiler` recording CUDA activity only: the cards' kernels and
copies and the runtime's launch calls, no host op, so the host keeps
its pace. The profiler's start-up, which takes seconds the first time
in a process, runs in the warm-up step of its schedule, before the
stretch begins. The events are reduced in memory (`reduce`); nothing is
written to disk. The reduction gives:

  * each card's busy time: the union of its kernel and copy intervals
    inside the stretch, overlapping ones counted once;
  * device time by family, summed over the cards, each kernel classed
    by its own name (`family`);
  * device time and calls by kernel name;
  * a breakdown: the device operations that took most time, and the
    first card's longest idle gaps by the operation that ended each,
    the one the card was waiting for.

`Context` is what a per-layer reader (`metrics/<name>.py`) gets.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

ATTENTION_KERNELS = ("flash_fwd",)  # the port's csrc/flash_attention.cu
COPY_PREFIXES = ("Memcpy", "Memset")
# cuDNN's kernels carry its name (`cutlass__5x_cudnn`, `..._5x_cudnn`,
# `cudnnKernelDataType_t`); older ones name the convolution itself.
CONV_MARKS = ("cudnn", "fprop", "convolve")
MATMUL_MARKS = ("nvjet", "gemm", "cublas", "cutlass")  # cuBLAS(Lt)
POOL_MARKS = ("pool", "reduce_kernel")
# A host range's copy on the device timeline spans kernels; not one.
ANNOTATIONS = ("ProfilerStep", "defer:")
MICROBATCHES = "defer_pipeline_microbatches_total"


def family(kernel: str) -> str:
    """The family of a device operation, from its name alone."""
    if any(k in kernel for k in ATTENTION_KERNELS):
        return "attention"
    if kernel.startswith(COPY_PREFIXES):
        return "copies"
    n = kernel.lower()
    if any(m in n for m in CONV_MARKS):
        return "conv"
    if any(m in n for m in MATMUL_MARKS):
        return "matmul"
    if any(m in n for m in POOL_MARKS):
        return "pool"
    return "pointwise"


@dataclasses.dataclass
class Traced:
    window_s: float
    busy_s: float  # mean over the cards used
    family_ms: dict[str, float]  # device ms, summed over the cards
    kernel_ms: dict[str, float]  # device ms by name, calls inside the stretch
    kernel_calls: dict[str, int]  # those calls by name
    breakdown: dict[str, list]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(torch, events, wall_s: float, devices: list[int]) -> Traced:
    """The stretch's device events as the readers need them (times in us
    from the start of recording, clipped to the stretch)."""
    cpu = torch.autograd.DeviceType.CPU
    end_us = wall_s * 1e6
    family_us: dict[str, float] = collections.Counter()
    kernel_us: dict[str, float] = collections.Counter()
    kernel_n: dict[str, int] = collections.Counter()
    intervals: dict[int, list[tuple[float, float, str]]] = collections.defaultdict(list)
    for e in events:
        if e.device_type == cpu or e.name.startswith(ANNOTATIONS):
            continue  # the runtime's calls on the host; ranges
        start, end = e.time_range.start, e.time_range.end
        a, b = max(start, 0.0), min(end, end_us)
        if b <= a:
            continue
        intervals[e.device_index].append((a, b, e.name))
        family_us[family(e.name)] += b - a
        if 0.0 <= start and end <= end_us:
            kernel_us[e.name] += end - start
            kernel_n[e.name] += 1
    unions = {d: _union([(a, b) for a, b, _ in intervals.get(d, [])])
              for d in devices}
    busy = [sum(b - a for a, b in u) for u in unions.values()]
    first = devices[0] if devices else None
    breakdown = {
        "device_ops": [[name[:160], us / 1e6] for name, us in
                       sorted(kernel_us.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": (_gap_names(unions[first], intervals.get(first, []), end_us)
                      if first is not None else []),
    }
    return Traced(
        window_s=wall_s,
        busy_s=sum(busy) / max(len(busy), 1) / 1e6,
        family_ms={k: v / 1e3 for k, v in family_us.items()},
        kernel_ms={k: v / 1e3 for k, v in kernel_us.items()},
        kernel_calls=dict(kernel_n),
        breakdown=breakdown,
    )


def _gap_names(union, ops, end_us: float) -> list[list]:
    """Idle seconds of one card by the operation that ended each gap
    (the stretch's end for a gap that runs to it)."""
    starts = sorted((a, name) for a, _, name in ops)
    by: dict[str, float] = collections.Counter()
    at, i = 0.0, 0
    for a, b in union + [(end_us, end_us)]:
        if a > at:
            while i < len(starts) and starts[i][0] < a:
                i += 1
            name = (f"waiting for {starts[i][1][:120]}" if i < len(starts)
                    else "the stretch's end")
            by[name] += (a - at) / 1e6
        at = max(at, b)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]


class Stretch:
    """Profiles `trace_seconds` of CUDA activity from the thread that
    calls `hold`, taking the program's counters at both ends."""

    def __init__(self, mix: dict, devices: list[int]):
        self.devices = devices
        self.seconds = float(mix.get("trace_seconds", 3.0))
        self.events: list | None = None
        self.t0 = self.wall_s = 0.0

    @staticmethod
    def profiler(torch):
        """CUDA activity only (the host's ops where there is no card, so
        that the path runs on the CPU), after one warm-up step."""
        act = torch.profiler.ProfilerActivity
        return torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))

    def hold(self, sleep_for, snapshot, registry: dict) -> None:
        import torch

        from benchmark.harness import clock

        prof = self.profiler(torch)
        prof.start()  # the warm-up step: the profiler's start-up
        prof.step()  # recording from here
        self.t0 = clock()
        registry["stretch_start"] = snapshot()
        sleep_for(self.seconds)
        registry["stretch_end"] = snapshot()
        self.wall_s = clock() - self.t0
        prof.stop()
        self.events = prof.events()

    def result(self, torch) -> Traced | None:
        if self.events is None:
            return None
        return reduce(torch, self.events, self.wall_s, self.devices)


@dataclasses.dataclass
class Context:
    """What a per-layer reader gets."""

    cell: Any  # harness.Cell
    outcome: Any  # harness.Outcome
    traced: Traced | None
    registry: dict[str, Any]  # program registry snapshots by moment
    device: dict

    @property
    def chips(self) -> int:
        return int(self.cell.spec["chips"])

    def microbatches(self) -> float | None:
        """Microbatches the program dispatched during the stretch."""
        return self.counter_delta(MICROBATCHES, "stretch_start", "stretch_end")

    def per_microbatch_ms(self, *families: str) -> float | None:
        t, n = self.traced, self.microbatches()
        if t is None or not n or not t.busy_s:
            return None
        return sum(t.family_ms.get(f, 0.0) for f in families) / n

    def idle_share_pct(self) -> float | None:
        """100 x (1 - a card's busy seconds over the stretch's), averaged
        over the cards."""
        t = self.traced
        if t is None or not t.busy_s or not t.window_s:
            return None
        return 100.0 * (1.0 - t.busy_s / t.window_s)

    def counter_delta(self, name: str, a: str, b: str) -> float | None:
        snaps = [self.registry.get(k, {}).get("counters", {}).get(name)
                 for k in (a, b)]
        if snaps[1] is None:
            return None
        return snaps[1] - (snaps[0] or 0)
