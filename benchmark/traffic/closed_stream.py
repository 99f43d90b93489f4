"""Closed loop of microbatches: the offline scenario.

A feeder thread keeps `run_defer`'s input queue full (`queue_depth`
items) with microbatches of `batch` images cycled from a pool of `pool`
distinct ones drawn from the seed, held in page-locked host memory when
`pinned`. Result i is the output of pool entry i mod `pool`: the queue
keeps order.

Warm-up: at least `warmup_results` results and `warmup_s` seconds from
the first. The next result taken opens the window; `images_per_s` is
the images of the results taken in the following `seconds` over those
seconds.

Mix parameters: batch, pool, image, pinned, queue_depth,
warmup_results, warmup_s, trace_seconds.
"""

from __future__ import annotations

import threading

from benchmark import weights
from benchmark.harness import Outcome


def entries(mix: dict) -> int:
    return int(mix["pool"])


def entry_shape(mix: dict) -> tuple[int, ...]:
    return (int(mix["batch"]), *(int(d) for d in mix["image"]))


def images_per_result(mix: dict) -> int:
    return int(mix["batch"])


def prepare(rt, model) -> list:
    if tuple(model.input_shape) != tuple(int(d) for d in rt.mix["image"]):
        raise ValueError(f"the mix's images {rt.mix['image']} are not the "
                         f"model's input {model.input_shape}")
    dev = rt.devices[0]
    return weights.host_entries(
        rt.seed, entries(rt.mix), entry_shape(rt.mix), dev,
        pinned=bool(rt.mix.get("pinned")) and dev.type == "cuda")


def drive(rt, pool: list) -> tuple[float, float]:
    mix, c = rt.mix, rt.consumer

    def feed():
        i = 0
        while rt.put(pool[i % len(pool)]):
            i += 1

    feeder = threading.Thread(target=feed, name="bench-feeder", daemon=True)
    feeder.start()
    try:
        c.wait_count(1, timeout=1200)
        if not c.times:
            raise RuntimeError("no result came back")
        c.wait_count(int(mix["warmup_results"]), timeout=600)
        rt.sleep_until(c.times[0] + float(mix["warmup_s"]))
        c.open_window(rt.seconds)
        if not c.window_open.wait(timeout=120):
            raise RuntimeError("no result came back after the warm-up")
        t0 = c.t0
        t1 = t0 + rt.seconds
        rt.hold_window(t0, t1)
    finally:
        rt.stop.set()
        feeder.join(timeout=30)
    return t0, t1


def report(rt, pool: list, window: tuple[float, float]) -> Outcome:
    t0, t1 = window
    done = sum(1 for t in rt.consumer.times if t0 < t <= t1)
    images = done * images_per_result(rt.mix)
    return Outcome(
        metrics={"images_per_s": images / (t1 - t0)},
        attempted=images,
        failed=0,
        t0=t0,
        t1=t1,
        checked=[(i % len(pool), out) for i, out in rt.consumer.sample],
        extra={"results_in_window": done},
    )
