#!/usr/bin/env python3
"""flash_decode on the card at the decode path's shape, across depths.

    python3 scripts/bench_flash_decode.py

Needs one CUDA card. At B=4, Hq=32, Hkv=8, S=4096, Dh=128, bf16 and
window 4096 (Mistral-7B's tick shape), for several sets of per-sequence
positions, prints the kernel's device time, its plain version's, one
library call's (scaled_dot_product_attention over all S rows, the
yardstick the port never calls), the bound (live K/V bytes plus q and o
over 3.35 TB/s), and the wrapper's host time per call; then the G=8
case (Hq=64). Device times: CUDA events over 100 back-to-back calls
queued behind a ~0.1 s device sleep, so the host's enqueue is not
timed. Last line: one JSON object with every figure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12
SHAPE = (4, 32, 8, 4096, 128)  # B, Hq, Hkv, S, Dh
WINDOW = 4096
POSITIONS = ([4095, 2047, 130, 0], [150] * 4, [1000] * 4, [4095] * 4)


def device_us(fn, iters: int = 100) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def host_us(fn, iters: int = 100) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    from defer_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
        live_rows,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hkv, s, dh = SHAPE
    k, v = (torch.randn(b, hkv, s, dh, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    rows = []
    for g in (hq // hkv, 8):
        q = torch.randn(b, hkv * g, dh, generator=gen, device="cuda")
        q = q.bfloat16()
        for pos in POSITIONS if g == hq // hkv else POSITIONS[:1]:
            posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
            j = torch.arange(s, device="cuda")
            mask = ((j[None, :] <= posv[:, None])
                    & (j[None, :] > posv[:, None] - WINDOW))[:, None, None]
            live = sum(live_rows(p, s, WINDOW) for p in pos)
            nbytes = (2 * live * hkv * dh + 2 * b * hkv * g * dh) * 2
            row = {
                "G": g,
                "pos": pos,
                "kernel_us": device_us(
                    lambda: flash_decode(q, k, v, posv, window=WINDOW)),
                "plain_us": device_us(
                    lambda: flash_decode_plain(q, k, v, posv,
                                               window=WINDOW)),
                "sdpa_us": device_us(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], k, v, attn_mask=mask,
                        enable_gqa=True)),
                "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
                "wrapper_host_us": host_us(
                    lambda: flash_decode(q, k, v, posv, window=WINDOW)),
            }
            rows.append(row)
            print(f"G={g} pos={pos}: kernel {row['kernel_us']:.3f} us, "
                  f"plain {row['plain_us']:.3f} us, sdpa (all {s} rows) "
                  f"{row['sdpa_us']:.3f} us, bound {row['bound_us']:.3f} us "
                  f"({live} live rows), wrapper host "
                  f"{row['wrapper_host_us']:.2f} us", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "shape": SHAPE, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
