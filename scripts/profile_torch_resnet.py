#!/usr/bin/env python3
"""Where a ResNet50 microbatch spends its time in defer_tpu_torch.

    python3 scripts/profile_torch_resnet.py [--batches 8,32,128]
        [--microbatches 32]

Needs one CUDA card. Builds ResNet50 (224x224x3, 1000 classes, random
weights from seed 0) cut at model.default_cuts(4) (add_4/8/12) into 4
stages on cuda:0, bf16, and for each batch reports:

  * host: ms the host needs to enqueue one microbatch, timed on an idle
    card (median of 10, device-resident input);
  * device: kernel ms per microbatch from torch.profiler, by family
    (conv, batch norm, elementwise, pool, dense, copies: each kernel
    counted under the PyTorch op that launched it), and the kernel
    launches per microbatch, in total and by family;
  * stream: microbatches/s of Pipeline.stream fed device-resident and
    pageable CPU tensors (in turns, twice), images/s and MFU (images/s x
    graph_flops per image over the card's bf16 peak), and the device's
    idle share in a profiled window of the device-fed stream.

At batch 32 it also profiles the unplaced graph (`Graph.apply` on the
params cast to bf16, kernels stored HWIO, batch norms unfolded): the
launches and copies that the stages' placement saves.

Prints one line per figure and, last, one JSON object with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ("conv", "batch_norm", "elementwise", "pool", "dense", "copies")


def _family(op: str) -> str:
    """Family of the PyTorch op that launched a kernel."""
    n = op.lower()
    if "conv" in n:
        return "conv"
    if "addcmul" in n:
        return "batch_norm"
    if "pool" in n or n in ("aten::mean", "aten::amax"):
        return "pool"
    if n in ("aten::addmm", "aten::mm", "aten::matmul", "aten::bmm"):
        return "dense"
    if n in ("aten::copy_", "aten::_to_copy", "aten::clone",
             "aten::contiguous", "aten::constant_pad_nd"):
        return "copies"
    return "elementwise"


def profile_window(torch, run, n: int) -> dict:
    """torch.profiler over `run()` (which pushes n microbatches and
    waits for the last): device ms and launches per microbatch, in total
    and by family, and the device's idle share of the window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    fam_us = dict.fromkeys(FAMILIES, 0.0)
    fam_launches = dict.fromkeys(FAMILIES, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        fam = _family(e.name)
        fam_us[fam] += sum(k.duration for k in e.kernels)
        fam_launches[fam] += len(e.kernels)
    busy_us = 0.0
    launches = 0
    for e in prof.key_averages():
        # Device-side kernels and copies only.
        if (e.self_device_time_total <= 0
                or e.device_type != torch.autograd.DeviceType.CUDA):
            continue
        busy_us += e.self_device_time_total
        launches += e.count
    return {
        "device_ms_per_microbatch": busy_us / n / 1e3,
        "device_ms_by_family": {k: v / n / 1e3 for k, v in fam_us.items()},
        "launches_per_microbatch": launches / n,
        "launches_by_family": {k: v / n for k, v in fam_launches.items()},
        "idle_share": 1.0 - busy_us / (wall * 1e6),
        "window_s": wall,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,32,128")
    ap.add_argument("--microbatches", type=int, default=32)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    from defer_tpu_torch import DEFER, DeferConfig
    from defer_tpu_torch.models import get_model
    from defer_tpu_torch.parallel.pipeline import cast_params_to_storage
    from defer_tpu_torch.utils.flops import graph_flops, peak_flops
    from defer_tpu_torch.utils.sync import hard_sync

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    peak = peak_flops(torch.cuda.get_device_name(0))
    model = get_model("resnet50")
    cuts = model.default_cuts(4)
    config = DeferConfig(compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    per_image = graph_flops(model.graph, params, (1, *model.input_shape))
    pipe, _ = DEFER(devices=[dev], config=config).build_pipeline(
        model, cuts, params=params)
    n = args.microbatches
    report = {"card": card, "cuts": cuts, "flops_per_image": per_image,
              "peak_flops": peak, "batches": {}}
    print(f"resnet50 cut at {cuts}, {per_image:.6g} FLOP an image, peak "
          f"{peak:.4g} FLOP/s; {card}", flush=True)

    for batch in (int(b) for b in args.batches.split(",")):
        gen = torch.Generator(device=dev).manual_seed(batch)
        feeds = {
            "device": [torch.randn((batch, *model.input_shape), generator=gen,
                                   device=dev) for _ in range(n)],
        }
        feeds["pageable"] = [x.cpu() for x in feeds["device"]]
        for _ in range(3):
            hard_sync(pipe(feeds["device"][0]))

        host = []
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(feeds["device"][i % n])
            host.append(time.perf_counter() - t0)
            hard_sync(out)
        host_ms = statistics.median(host) * 1e3

        rates: dict[str, list[float]] = {}
        for kind in ("device", "pageable", "device", "pageable"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = None
            for last in pipe.stream(feeds[kind]):
                pass
            hard_sync(last)
            rates.setdefault(kind, []).append(n / (time.perf_counter() - t0))

        def device_stream():
            last = None
            for last in pipe.stream(feeds["device"]):
                pass
            hard_sync(last)

        prof = profile_window(torch, device_stream, n)
        images = {k: [r * batch for r in v] for k, v in rates.items()}
        mfu = {k: [i * per_image / peak for i in v] for k, v in images.items()}
        row = {"host_ms_per_microbatch": host_ms, **prof,
               "images_per_sec": images, "mfu": mfu}
        report["batches"][batch] = row
        print(f"batch {batch}: host {host_ms:.3f} ms to enqueue a microbatch; "
              f"device {prof['device_ms_per_microbatch']:.3f} ms, "
              f"{prof['launches_per_microbatch']:.1f} launches a microbatch; "
              f"idle share {prof['idle_share']:.4f}", flush=True)
        print(f"batch {batch}: device ms by family "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          prof["device_ms_by_family"].items())
              + "; launches by family "
              + ", ".join(f"{k} {v:g}" for k, v in
                          prof["launches_by_family"].items()), flush=True)
        print(f"batch {batch}: images/s device-fed "
              + " and ".join(f"{x:.1f}" for x in images["device"])
              + ", pageable-fed "
              + " and ".join(f"{x:.1f}" for x in images["pageable"])
              + "; MFU device-fed "
              + " and ".join(f"{x:.4f}" for x in mfu["device"]), flush=True)

        if batch == 32:
            # The unplaced graph: HWIO kernels (cuDNN copies each to
            # channels-last on every call) and unfolded batch norms.
            stored = cast_params_to_storage(params, config)
            x = feeds["device"][0].to(torch.bfloat16)

            def unplaced():
                with torch.inference_mode():
                    for _ in range(n):
                        out = model.graph.apply(stored, x)
                hard_sync(out)

            unplaced()
            report["unplaced_batch32"] = profile_window(torch, unplaced, n)
            u = report["unplaced_batch32"]
            print(f"batch 32 unplaced graph: "
                  f"{u['launches_per_microbatch']:.1f} launches a "
                  f"microbatch, device {u['device_ms_per_microbatch']:.3f} "
                  f"ms; by family "
                  + ", ".join(f"{k} {v:g}" for k, v in
                              u["launches_by_family"].items()), flush=True)
        del feeds
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
