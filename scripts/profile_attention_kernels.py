#!/usr/bin/env python3
"""Device time of the attention kernels, split by CUDA kernel.

    python3 scripts/profile_attention_kernels.py [--calls 20]

Runs `flash_attention` at BERT-base's shape (16, 12, 128, 64) bf16,
`paged_flash_prefill` on one 64-token chunk of Mistral-7B's shape (Hq 32,
Hkv 8, Dh 128, 16-row blocks, a 256-column table) at starts 64, 1984 and
4032, and `flash_decode` and `paged_flash_decode` at Mistral-7B's decode
shape (B 4, Hq 32, Hkv 8, Dh 128, S 4096 or a 256-column table of 16-row
blocks, window 4096) at a deep mix of positions [4095, 2047, 130, 0] and
at the serving tick's depths [170, 176, 182, 188]; the paged kernels on a
bf16 and an int8 pool; inputs from chip_smoke's seeded helpers. For each
it prints the mean device time a call of every CUDA kernel the call
launched (torch.profiler), so a kernel that merges its splits in a second
launch shows its main kernel and its merge apart (every kernel here now
merges inside its launch; an older tree's prefill did not), and the
call's time by CUDA events over back-to-back calls
(chip_smoke.cuda_time_ms). `scripts/profile_paged_prefill.py` has the
prefill in detail. It runs
against the package beside it, so the same script, copied into an older
tree, times that tree's kernels. Needs one CUDA card; imports neither jax
nor defer_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def _by_kernel(fn, calls: int) -> list:
    """(kernel name, launches, mean device us a call) of `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out.append((e.key, e.count, us / calls))
    return out


# The decode kernels' timed positions (chip_smoke's DEEP_POS, TICK_POS).
DECODE_POS = {"deep": [4095, 2047, 130, 0], "tick": [170, 176, 182, 188]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from defer_tpu_torch.ops.flash_attention import flash_attention
    from defer_tpu_torch.ops.flash_decode import flash_decode
    from defer_tpu_torch.ops.paged_flash_decode import paged_flash_decode
    from defer_tpu_torch.ops.paged_flash_prefill import paged_flash_prefill

    print(chip_smoke.card_line())
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = chip_smoke._bert_qkv(gen, 16, 12, 128, 64, torch.bfloat16)
    runs = [("flash_attention bert bf16", lambda: flash_attention(q, k, v))]
    for start in (64, 1984, 4032):
        q2, pk, pv, tables, sv = chip_smoke._paged_inputs(
            1, 32, 8, 64, 128, 16, 256, torch.bfloat16, [start], 0
        )
        (kq, ks), (vq, vs) = chip_smoke._int8_pool(pk), chip_smoke._int8_pool(pv)
        runs.append((
            f"paged_flash_prefill start {start} bf16",
            lambda q2=q2, pk=pk, pv=pv, tables=tables, sv=sv:
                paged_flash_prefill(q2, pk, pv, tables, sv, window=4096),
        ))
        runs.append((
            f"paged_flash_prefill start {start} int8",
            lambda q2=q2, kq=kq, vq=vq, tables=tables, sv=sv, ks=ks, vs=vs:
                paged_flash_prefill(q2, kq, vq, tables, sv, window=4096,
                                    scale_k=ks, scale_v=vs),
        ))
    dgen = torch.Generator(device="cuda").manual_seed(1)
    qd, kd, vd = chip_smoke._decode_qkv(dgen, 4, 32, 8, 4096, 128,
                                        torch.bfloat16)
    for name, pos in DECODE_POS.items():
        posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
        runs.append((
            f"flash_decode {name} {pos} bf16",
            lambda posv=posv: flash_decode(qd, kd, vd, posv, window=4096),
        ))
        q1, pk, pv, tables, pv1 = chip_smoke._paged_inputs(
            4, 32, 8, None, 128, 16, 256, torch.bfloat16, pos, 0
        )
        (kq, ks), (vq, vs) = chip_smoke._int8_pool(pk), chip_smoke._int8_pool(pv)
        runs.append((
            f"paged_flash_decode {name} {pos} bf16",
            lambda q1=q1, pk=pk, pv=pv, tables=tables, pv1=pv1:
                paged_flash_decode(q1, pk, pv, tables, pv1, window=4096),
        ))
        runs.append((
            f"paged_flash_decode {name} {pos} int8",
            lambda q1=q1, kq=kq, vq=vq, tables=tables, pv1=pv1, ks=ks, vs=vs:
                paged_flash_decode(q1, kq, vq, tables, pv1, window=4096,
                                   scale_k=ks, scale_v=vs),
        ))
    for label, fn in runs:
        rows = _by_kernel(fn, args.calls)
        total = sum(us for _, _, us in rows)
        call_us = chip_smoke.cuda_time_ms(fn) * 1e3
        print(f"{label}: {total:.3f} us of kernels a call, {len(rows)} "
              f"kernel(s); {call_us:.3f} us a call back to back")
        for name, count, us in sorted(rows, key=lambda r: -r[2]):
            print(f"  {us:9.3f} us  x{count // args.calls}  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
