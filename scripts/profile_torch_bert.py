#!/usr/bin/env python3
"""Where a BERT-base microbatch spends its time in defer_tpu_torch.

    python3 scripts/profile_torch_bert.py [--microbatches 32] [--trace DIR]

Needs one CUDA card. Builds the chip smoke's main-path pipeline
(bert_base, seq 128, batch 16, bf16, cut at encoder_2/5/8_out into 4
stages on cuda:0, random weights from seed 0) and reports:

  * host: seconds the host needs to enqueue one microbatch, timed on an
    idle card (median of 10, device-resident input);
  * device: kernel time per microbatch from torch.profiler, by kernel
    family (flash attention, matrix products, the rest), and the number
    of kernel launches per microbatch;
  * stream: microbatches/s of Pipeline.stream fed three ways — pageable
    CPU tensors (what a queue usually holds), pinned CPU tensors and
    tensors already on the card — then of run_defer behind its queues,
    and the device's idle share in a profiled window of the pageable
    stream.

Prints one line per figure and, last, one JSON object with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CUTS = ["encoder_2_out", "encoder_5_out", "encoder_8_out"]
BATCH, SEQ = 16, 128


def _family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--microbatches", type=int, default=32)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace of the window here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.utils.sync import hard_sync

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    model = get_model("bert_base", seq_len=SEQ)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        batch_size=BATCH)
    defer = DEFER(devices=[dev],
                  config=DeferConfig(compute_dtype=torch.bfloat16))
    pipe, _ = defer.build_pipeline(model, CUTS, params=params)
    n = args.microbatches
    ids = torch.randint(0, 30522, (n, BATCH, SEQ),
                        generator=torch.Generator().manual_seed(1))
    feeds = {
        "pageable": [ids[i].clone() for i in range(n)],
        "pinned": [ids[i].clone().pin_memory() for i in range(n)],
        "device": [ids[i].to(dev) for i in range(n)],
    }
    for _ in range(3):
        hard_sync(pipe(feeds["device"][0]))

    host = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(feeds["device"][i % n])
        host.append(time.perf_counter() - t0)
        hard_sync(out)
    host_s = statistics.median(host)
    print(f"host: {host_s * 1e3:.3f} ms to enqueue one microbatch "
          f"(median of 10, idle card)", flush=True)

    stream = {}
    for kind in ("pageable", "pinned", "device", "pageable", "pinned",
                 "device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = None
        for last in pipe.stream(feeds[kind]):
            pass
        hard_sync(last)
        rate = n / (time.perf_counter() - t0)
        stream.setdefault(kind, []).append(rate)
    for kind, rates in stream.items():
        print(f"stream: {kind} inputs {rates[0]:.2f} and {rates[1]:.2f} "
              f"microbatches/s ({rates[1] * BATCH:.0f} items/s)", flush=True)

    # The same pipeline behind the queue contract, as chip_smoke.py
    # drives it: run_defer in a thread, the caller feeding and draining.
    queued = []
    for _ in range(2):
        in_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue()
        worker = threading.Thread(
            target=defer.run_defer, args=(model, CUTS, in_q, out_q),
            kwargs={"params": params}, daemon=True,
        )
        worker.start()
        for x in feeds["pageable"]:
            in_q.put(x)
        in_q.put(None)
        out_q.get(timeout=300)
        t0 = time.perf_counter()
        for _ in range(n - 1):
            out_q.get(timeout=300)
        queued.append((n - 1) / (time.perf_counter() - t0))
        worker.join(timeout=60)
    print(f"run_defer: {queued[0]:.2f} and {queued[1]:.2f} microbatches/s "
          f"after the first output ({queued[1] * BATCH:.0f} items/s)",
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for last in pipe.stream(feeds["pageable"]):
            pass
        hard_sync(last)
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "bert_stream.json"))
    fam_us: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        dt = e.self_device_time_total
        # Device-side kernels and copies only: the GPU copies of the
        # stage annotations span their kernels and would count twice.
        if (dt <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("defer:")):
            continue
        fam = _family(e.key)
        fam_us[fam] = fam_us.get(fam, 0.0) + dt
        launches += e.count
    busy_us = sum(fam_us.values())
    device_ms = busy_us / n / 1e3
    idle = 1.0 - busy_us / (wall * 1e6)
    print(f"device: {device_ms:.3f} ms of kernels per microbatch, "
          f"{launches / n:.1f} launches per microbatch; by family "
          + ", ".join(f"{k} {v / n / 1e3:.3f} ms"
                      for k, v in sorted(fam_us.items())), flush=True)
    print(f"device: idle share {idle:.3f} of a {wall:.3f}s window of "
          f"{n} pageable-fed microbatches", flush=True)
    print(card, flush=True)
    print(json.dumps({
        "card": card,
        "host_ms_per_microbatch": host_s * 1e3,
        "device_ms_per_microbatch": device_ms,
        "device_ms_by_family": {k: v / n / 1e3 for k, v in fam_us.items()},
        "launches_per_microbatch": launches / n,
        "idle_share_pageable": idle,
        "stream_microbatches_per_s": stream,
        "run_defer_microbatches_per_s": queued,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
