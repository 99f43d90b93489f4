#!/usr/bin/env python3
"""Host and device time of one steady decode tick, flat against paged.

    python3 scripts/profile_paged_tick.py [--layers 32] [--depth 150]

Builds GptDecoder(mistral_config()) in bf16 on the card (random weights
from a seed; `--layers` cuts the depth), then times, in turns (flat,
paged, paged, flat, twice over), one steady tick of the flat
DecodeServer's step and one of PagedDecodeServer(attention="pallas")'s
`step()`, both at 4 slots from `--depth` on, with chip_smoke's
`time_tick` (host ms to issue on an idle card, wall ms, profiler device
ms by kernel family, launches). Then it prints, for one tick of each,
the host-side operators that took the most self CPU time
(torch.profiler), which is where a host-bound tick's time goes. Needs
one CUDA card; imports neither jax nor defer_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def _host_ops(tick, top: int) -> str:
    import torch

    for _ in range(2):
        tick()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as prof:
        tick()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_cpu_time_total",
                                     row_limit=top)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--depth", type=int, default=150)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from defer_tpu_torch import GptDecoder, PagedDecodeServer, mistral_config

    print(chip_smoke.card_line())
    dec = GptDecoder(mistral_config(num_layers=args.layers),
                     compute_dtype=torch.bfloat16)
    params = dec.cast_params(
        dec.init(torch.Generator(device="cuda").manual_seed(0))
    )
    srv = PagedDecodeServer(
        dec, params, num_blocks=chip_smoke.PAGED_BLOCKS,
        block_size=chip_smoke.PAGED_BS, max_batch=chip_smoke.DECODE_SLOTS,
        attention="pallas",
    )
    ticks = {"flat": chip_smoke.flat_tick(dec, params, args.depth),
             # Enough budget for the four timed turns and the host
             # profile below, 19 and 3 ticks each.
             "paged": chip_smoke.paged_tick(srv, dec.cfg.vocab_size,
                                            args.depth, steps=128)}
    for rnd, name in enumerate(["flat", "paged", "paged", "flat"] * 2):
        split = chip_smoke.time_tick(ticks[name])
        print(f"{name} (turn {rnd}): host {split['host_ms']:.4f} ms, wall "
              f"{split['wall_ms']:.4f} ms, device {split['device_ms']:.4f} "
              f"ms, {split['launches']:.0f} launches, idle share "
              f"{split['idle_share']:.4f}; "
              + ", ".join(f"{k} {v:.4f} ms"
                          for k, v in split["family_ms"].items()))
    for name, tick in ticks.items():
        print(f"-- host operators of one {name} tick (self CPU time)")
        print(_host_ops(tick, args.top))
    for mod in ("jax", "defer_tpu"):
        if mod in sys.modules:
            print(f"FAIL: {mod} was imported")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
