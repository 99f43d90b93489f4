#!/usr/bin/env python3
"""Where `paged_flash_prefill`'s time goes on the card.

    python3 scripts/profile_paged_prefill.py [--calls 50] [--plans 8,3]
                                             [--stamps]

On one 64-token chunk of Mistral-7B's shape (B 1, Hq 32, Hkv 8, Dh 128,
16-row blocks, a 256-column table, window 4096; inputs from chip_smoke's
seeded helpers) at starts 64, 1984 and 4032, and a 512-token chunk at
start 1536, on a bf16 and an int8 pool, it prints:

  * the device us a call of every CUDA kernel the call launched
    (torch.profiler), so a call that merges its splits in a second
    launch shows the main kernel and the merge apart, and the call's us
    by CUDA events over back-to-back calls (chip_smoke.cuda_time_ms);
  * the kernel's own count of its runs on the card a call (`card_runs`,
    and the merge's where the tree has one);
  * the wrapper's host us a call at start 64 on an idle card
    (chip_smoke.host_time_us over 300 calls);
  * `csrc/paged_flash_prefill.cu` built again in a temporary directory
    with `-Xptxas -v`: each kernel's registers, spill bytes and shared
    memory, and every ptxas wgmma serialization note (C75xx).

With --plans S,... (a tree whose wrapper has `_prefill_plan`) it also
times each call with the plan forced to S ranks a cluster. With
--stamps it builds a patched copy of the source in the temporary
directory (the shipped source has no diagnostic switch; a patch that no
longer finds its place fails the script) whose thread 0 of each CTA
writes the global timer at each phase, and prints, at starts 64 and 1984
on a bf16 pool, each phase's median and p90 ns over the CTAs that walk
tiles, a CTA's life, the call's span, and the most CTAs resident on one
SM at once. It runs against the package beside it, so the same script,
copied into an older tree, times that tree's kernel (without --plans and
--stamps). Needs one CUDA card; imports neither jax nor defer_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402

STARTS = (64, 1984, 4032)
# (B, Hq, Hkv, T, Dh, bs, MB): the phase-5 chunk of Mistral-7B, and a
# chunk of 512 tokens (the card full without splits).
SHAPE = (1, 32, 8, 64, 128, 16, 256)
BIG = (1, 32, 8, 512, 128, 16, 256)


STAMP_DEFS = r"""
namespace {
constexpr int kStampSlots = 16;  // per CTA: phases 0-12, n in 14, the SM in 15
__device__ unsigned long long pf_stamps[1 << 20];
}
#define STAMP_AT(i)                                                         \
  {                                                                         \
    unsigned long long t_;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
    pf_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +          \
               blockIdx.x) * kStampSlots + (i)] = t_;                       \
  }
#define STAMP(i) if (threadIdx.x == 0) STAMP_AT(i)
"""
STAMP_EXPORTS = r"""
extern "C" int defer_paged_prefill_stamps(void* host, long long n) {
  return int(cudaMemcpyFromSymbol(host, pf_stamps, n * 8));
}
extern "C" int defer_paged_prefill_clear_stamps() {
  static unsigned long long zeros[1 << 20];
  return int(cudaMemcpyToSymbol(pf_stamps, zeros, sizeof(zeros)));
}
"""
# (old, new) text replacements of the source, each of which must match
# exactly once.
STAMPS = [
    ('#include "attn_wgmma.cuh"\n', '#include "attn_wgmma.cuh"\n' + STAMP_DEFS),
    ("  const int first = sp.c0 + rank * chunk * kCols;  // this rank's first column\n",
     "  const int first = sp.c0 + rank * chunk * kCols;  // this rank's first column\n"
     "  STAMP(0);\n  if (threadIdx.x == 0) {\n    unsigned sm;\n"
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "    const long long cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "    pf_stamps[cta * kStampSlots + 14] = n;\n"
     "    pf_stamps[cta * kStampSlots + 15] = sm;\n  }\n"),
    ("    wg::bar_sync(1, kConsumers);\n\n    Mask mk;\n",
     "    wg::bar_sync(1, kConsumers);\n    STAMP(1);\n\n    Mask mk;\n"),
    ("    acc.init();\n    wg::mbar_wait(k_full, 0);\n",
     "    acc.init();\n    wg::mbar_wait(k_full, 0);\n    STAMP(2);\n"),
    ("    acc.template softmax<kQuant, 0>(first, mk, lane, kmul[0], vmul[0]);\n",
     "    acc.template softmax<kQuant, 0>(first, mk, lane, kmul[0], vmul[0]);\n"
     "    STAMP(3);\n"),
    ("    if constexpr (!kQuant) {\n      wg::mbar_wait(v_full + (n - 1) % kStages",
     "    STAMP(4);\n    if constexpr (!kQuant) {\n"
     "      wg::mbar_wait(v_full + (n - 1) % kStages"),
    ("    acc.template issue_pv<0>(v_tile(n - 1));\n    wg::wgmma_wait<0>();\n"
     "    wg::hold(acc.o);\n",
     "    acc.template issue_pv<0>(v_tile(n - 1));\n    wg::wgmma_wait<0>();\n"
     "    wg::hold(acc.o);\n    STAMP(5);\n"),
    ("      copy(&tk, ks, k_full, t, blk);\n",
     "      if (t < 2 && lane == 0) STAMP_AT(10 + t);\n"
     "      copy(&tk, ks, k_full, t, blk);\n"),
    ("      acc.rescale();\n      acc.issue_qk(q_tile, k_tile(t));\n",
     "      if (t == 1) STAMP(12);\n"
     "      acc.rescale();\n      acc.issue_qk(q_tile, k_tile(t));\n"),
    ("    return;\n  }\n", "    STAMP(9);\n    return;\n  }\n"),
    ("  cluster.sync();  // every CTA's state is written\n",
     "  STAMP(6);\n  cluster.sync();  // every CTA's state is written\n  STAMP(7);\n"),
    ("  cluster.sync();  // no CTA leaves while a peer may read its state\n}\n",
     "  STAMP(8);\n  cluster.sync();  // no CTA leaves while a peer may read its state\n"
     "  STAMP(9);\n}\n"),
]
# Phase: (name, the phase it is timed from, the CTAs it is timed over:
# "walk" those that walk tiles, "merge" those that merge, "all").
PHASES = {
    10: ("K 0 issued", 0, "walk"), 11: ("K 1 issued", 0, "walk"),
    1: ("Q in shared memory", 0, "walk"), 2: ("K 0 landed", 1, "walk"),
    3: ("tile 0's softmax", 2, "walk"), 12: ("K 1, V 0 landed", 3, "walk"),
    4: ("the other tiles", 3, "walk"), 5: ("the last P V", 4, "walk"),
    6: ("state written", 0, "merge"), 7: ("cluster barrier", 6, "merge"),
    8: ("merge and store", 7, "merge"), 9: ("the end", 0, "all"),
}


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


def _runs_a_call(fn, pfp) -> str:
    """The card's count of the kernel's runs (and its merge's, where the
    tree has one) over one call."""
    import torch

    torch.cuda.synchronize()
    pfp.reset_card_runs()
    merge = getattr(pfp, "reset_merge_card_runs", None)
    if merge is not None:
        merge()
    fn()
    torch.cuda.synchronize()
    text = f"card runs a call {pfp.card_runs()}"
    if merge is not None:
        text += f", merge runs {pfp.merge_card_runs()}"
    return text


def _calls(start: int, shape=SHAPE, tag: str = ""):
    """(label, call) for a bf16 and an int8 pool at `start`."""
    import torch

    from defer_tpu_torch.ops.paged_flash_prefill import paged_flash_prefill

    b, hq, hkv, t, dh, bs, mb = shape
    q, pk, pv, tables, sv = chip_smoke._paged_inputs(
        b, hq, hkv, t, dh, bs, mb, torch.bfloat16, [start], 0)
    (kq, ks), (vq, vs) = chip_smoke._int8_pool(pk), chip_smoke._int8_pool(pv)
    return [
        (f"start {start}{tag} bf16",
         lambda: paged_flash_prefill(q, pk, pv, tables, sv, window=4096)),
        (f"start {start}{tag} int8",
         lambda: paged_flash_prefill(q, kq, vq, tables, sv, window=4096,
                                     scale_k=ks, scale_v=vs)),
    ]


def _build(tmp: str, name: str, patches=()) -> tuple:
    """The source, patched, built into `tmp` with -Xptxas -v: (library
    path, nvcc's return code, its output)."""
    from defer_tpu_torch.utils import nvcc

    source = (nvcc.CSRC / "paged_flash_prefill.cu").read_text()
    for old, new in patches:
        if source.count(old) != 1:
            raise RuntimeError(f"patch target not found once: {old!r}")
        source = source.replace(old, new)
    if patches:
        source += STAMP_EXPORTS
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    out = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run(
        [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-I", str(nvcc.CSRC),
         "-Xptxas", "-v", "-o", out, src],
        capture_output=True, text=True,
    )
    return out, proc.returncode, proc.stdout + proc.stderr


def _ptxas(log: str, rc: int) -> None:
    """What ptxas says of each kernel of the shipped source."""
    print(f"ptxas: nvcc rc {rc}")
    if rc:
        print(log[-3000:])
        return
    names = re.findall(r"Compiling entry function '(\w+)'", log)
    if shutil.which("c++filt") and names:
        dem = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout.split("\n")
        pretty = dict(zip(names, dem))
    else:
        pretty = {n: n for n in names}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = pretty.get(m.group(1), m.group(1))
            name = re.sub(r"\(anonymous namespace\)::", "", name)
        elif name and ("bytes spill" in line or "Used" in line):
            print(f"  {name[:80]}: {line.split(':', 1)[-1].strip()}")
    notes = sorted(set(re.sub(r"line \d+", "line N", n) for n in
                       re.findall(r"\(C75\d\d\)[^'\n]*", log)))
    print(f"ptxas wgmma serialization notes: {len(notes)}")
    for note in notes:
        print(f"  {note.strip()[:160]}")


def _stamps(pfp, path: str) -> None:
    """Each phase's ns at starts 64 and 1984 (bf16 pool) through the
    stamped library."""
    import numpy as np
    import torch

    lib = ctypes.CDLL(path)
    fn = lib.defer_paged_flash_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = pfp._kernel().argtypes
    lib.defer_paged_prefill_stamps.argtypes = [ctypes.c_void_p,
                                               ctypes.c_longlong]
    kernel = pfp._kernel
    pfp._kernel = lambda: fn
    pfp._launch_plan.cache_clear()
    try:
        for start in (64, 1984):
            label, call = _calls(start)[0]
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            lib.defer_paged_prefill_clear_stamps()
            call()
            torch.cuda.synchronize()
            buf = np.zeros(1 << 20, dtype=np.uint64)
            lib.defer_paged_prefill_stamps(buf.ctypes.data, buf.size)
            st = buf.reshape(-1, 16).astype(np.int64)
            st = st[st[:, 0] > 0]
            sets = {"walk": st[st[:, 14] > 0], "merge": st[st[:, 6] > 0],
                    "all": st}
            walk = sets["walk"]
            print(f"stamps {label}: {len(st)} CTAs ({len(walk)} walk tiles, "
                  f"{walk[:, 14].mean():.2f} tiles each; "
                  f"{len(sets['merge'])} merge) over "
                  f"{(st[:, 9].max() - st[:, 0].min()) / 1e3:.2f} us; a CTA "
                  f"that walks lives {np.median(walk[:, 9] - walk[:, 0]) / 1e3:.2f} "
                  f"us (median); CTAs start within "
                  f"{np.percentile(st[:, 0] - st[:, 0].min(), 90) / 1e3:.2f} "
                  "us of the first (p90)", flush=True)
            for col, (name, prev, over) in PHASES.items():
                rows = sets[over]
                rows = rows[rows[:, col] > 0]
                if not len(rows):
                    continue
                d = rows[:, col] - rows[:, prev]
                print(f"    {name:20s} {np.median(d):8.0f} ns median, "
                      f"{np.percentile(d, 90):8.0f} p90, from "
                      f"{'the start' if prev == 0 else PHASES[prev][0]}")
            resident = []
            for sm in np.unique(st[:, 15]):
                rows = st[st[:, 15] == sm]
                events = sorted([(r[0], 1) for r in rows]
                                + [(r[9], -1) for r in rows])
                now = most = 0
                for _, step in events:
                    now += step
                    most = max(most, now)
                resident.append(most)
            print(f"    SMs used {len(resident)}; CTAs resident per SM at "
                  f"most: {np.bincount(resident)} (index = count, value = "
                  "SMs)", flush=True)
    finally:
        pfp._kernel = kernel
        pfp._launch_plan.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--plans", default="",
                    help="ranks a cluster to force, comma-separated")
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from defer_tpu_torch.ops import paged_flash_prefill as pfp

    print(chip_smoke.card_line(), torch.__version__, flush=True)
    calls = [c for start in STARTS for c in _calls(start)]
    calls += _calls(1536, BIG, " T 512")
    for label, fn in calls:
        rows = _by_kernel(fn, args.calls)
        total = sum(us for _, _, us in rows)
        call_us = chip_smoke.cuda_time_ms(fn) * 1e3
        print(f"{label}: {call_us:.3f} us a call back to back; "
              f"{total:.3f} us of kernels a call, {len(rows)} kernel(s); "
              f"{_runs_a_call(fn, pfp)}", flush=True)
        for name, count, us in sorted(rows, key=lambda r: -r[2]):
            print(f"  {us:9.3f} us  x{count // args.calls}  {name[:90]}")
    host = chip_smoke.host_time_us(calls[0][1], iters=300)
    print(f"{calls[0][0]}: host_us_a_call {host:.2f} (idle card, 300 calls)",
          flush=True)
    for text in [t for t in args.plans.split(",") if t]:
        plan = pfp._prefill_plan
        pfp._prefill_plan = lambda *a, splits=int(text): splits
        pfp._launch_plan.cache_clear()
        try:
            for label, fn in calls:
                ms = chip_smoke.cuda_time_ms(fn)
                print(f"plan {text} {label}: {ms * 1e3:.3f} us a call",
                      flush=True)
        finally:
            pfp._prefill_plan = plan
            pfp._launch_plan.cache_clear()
    with tempfile.TemporaryDirectory() as tmp:
        _, rc, log = _build(tmp, "shipped")
        _ptxas(log, rc)
        if args.stamps:
            path, rc, log = _build(tmp, "stamps", STAMPS)
            if rc:
                print(log[-3000:])
                return 1
            _stamps(pfp, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
