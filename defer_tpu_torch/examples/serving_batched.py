"""Serving-loop demo: batch-1 clients, dynamically batched device work
(counterpart of examples/serving_batched.py).

The reference's driver streams one frame per queue item (reference
src/test.py:52-54): the natural serving shape, but a small share of a
card. This driver keeps the exact same client contract (put one item,
get one result, in order) and lets the runtime coalesce items into
device batches under a latency SLO:

    python -m defer_tpu_torch.examples.serving_batched --model resnet50 \\
        --batch-size 32 --wait-ms 5 --seconds 20

Prints per-item latency percentiles and throughput with batching on
vs off, so the SLO/throughput trade is visible.
"""

from __future__ import annotations

import argparse
import collections
import queue
import threading
import time

import torch

from defer_tpu_torch.api import DEFER
from defer_tpu_torch.config import DeferConfig
from defer_tpu_torch.examples import _launch
from defer_tpu_torch.models import get_model


def serve(model, params, cuts, cfg, seconds: float, devices) -> dict:
    """One timed session of batch-1 clients against run_defer."""
    inq: "queue.Queue" = queue.Queue(maxsize=256)
    outq: "queue.Queue" = queue.Queue()
    defer = DEFER(devices=devices, config=cfg)

    # analysis: domain(serving) the pipeline's stream loop; the clients
    # share only the queues with it
    def pipeline() -> None:
        defer.run_defer(model, cuts, inq, outq, params=params)

    worker = threading.Thread(target=pipeline, daemon=True)
    worker.start()

    # Respect the model's declared input dtype/shape (token-id models
    # take integers: example_input handles that).
    x = model.example_input(1).to(devices[0])
    latencies: list[float] = []
    done = threading.Event()
    sent = 0
    t_sent: "collections.deque[float]" = collections.deque()

    def drain() -> None:
        while not done.is_set() or not outq.empty():
            try:
                outq.get(timeout=0.1)
            except queue.Empty:
                continue
            if t_sent:
                latencies.append(time.perf_counter() - t_sent.popleft())

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()

    def guarded_put(item) -> None:
        # Bounded put + liveness check: if the worker died (bad cuts,
        # device failure past the retry budget) the feed must error
        # out, not deadlock on a full queue forever.
        while True:
            try:
                inq.put(item, timeout=1.0)
                return
            except queue.Full:
                if not worker.is_alive():
                    raise RuntimeError(
                        "pipeline worker died; see its traceback above"
                    ) from None

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t_sent.append(time.perf_counter())
        guarded_put(x)
        sent += 1
    guarded_put(None)
    worker.join(timeout=600)
    clean = not worker.is_alive()
    done.set()
    drainer.join(timeout=60)
    dt = time.perf_counter() - t0
    latencies.sort()
    n = len(latencies)
    stats = {
        "items_per_sec": n / dt,
        "p50_ms": latencies[n // 2] * 1e3 if n else None,
        "p99_ms": latencies[min(n - 1, int(n * 0.99))] * 1e3 if n else None,
        "completed": n,
        "sent": sent,
    }
    if not clean:
        stats["warning"] = "worker did not exit within 600s; stats truncated"
    elif n != sent:
        # Elastic re-dispatch may drop in-flight items; their stale
        # send-times then skew every later latency pairing.
        stats["warning"] = (
            f"{sent - n} item(s) dropped (pipeline recovery?); latency "
            "percentiles may be skewed"
        )
    return stats


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--cuts", default=None, help="comma-separated, or 'auto'")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--wait-ms", type=float, default=5.0)
    ap.add_argument("--seconds", type=float, default=10.0)
    _launch.add_device_flag(ap)
    return ap


def run(args: argparse.Namespace, *, params=None,
        compute_dtype=None) -> dict:
    """Batching off, then on; returns both sessions' stats."""
    devs = _launch.devices(args)
    model = get_model(args.model)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    cuts = (
        args.cuts
        if args.cuts in (None, "auto")
        else [c.strip() for c in args.cuts.split(",") if c.strip()]
    )

    base = DeferConfig(compute_dtype=compute_dtype or torch.bfloat16)
    batched = base.replace(
        dynamic_batch_size=args.batch_size,
        batch_wait_s=args.wait_ms / 1e3,
    )
    print(f"batching OFF ({args.seconds:.0f}s)...")
    off = serve(model, params, cuts, base, args.seconds, devs)
    print(f"  {off}")
    print(
        f"batching ON (<= {args.batch_size}/dispatch, "
        f"{args.wait_ms:.1f} ms SLO, {args.seconds:.0f}s)..."
    )
    on = serve(model, params, cuts, batched, args.seconds, devs)
    print(f"  {on}")
    if off["items_per_sec"]:
        print(
            f"throughput: {on['items_per_sec'] / off['items_per_sec']:.1f}x "
            "with batching"
        )
    return {"off": off, "on": on}


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
