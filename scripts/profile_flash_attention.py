#!/usr/bin/env python3
"""Where `flash_attention`'s time goes on the card.

    python3 scripts/profile_flash_attention.py [--quick]

At BERT-base's (16, 12, 128, 64), ViT-B/16's (32, 12, 197, 64) and GPT-2
small's causal (4, 12, 512, 64) shapes, bf16 strided head views as the
main path hands them over (chip_smoke._bert_qkv), it prints:

  * the wrapper's device time a call (CUDA events over back-to-back
    calls, chip_smoke.cuda_time_ms), SDPA's beside it, and the
    wrapper's host time a call on an idle card (chip_smoke.host_time_us
    over 300 calls, the tensor-map encodes included);
  * unless --quick: `csrc/flash_attention.cu` built again, as it is and
    as two patched copies in a temporary directory (each timed through
    the C entry point with the same inputs, ptxas's wgmma serialization
    notes and register counts beside it; the shipped build's host time a
    call of the C entry alone): "skeleton" (no wgmma, no exponentials:
    copies, barriers and the store alone) and "stamps" (the global timer
    at each phase of every CTA: the median time of each phase, CTAs
    resident per SM). The script fails if a patch no longer finds its
    place in the source.

It runs against the package beside it; --quick also runs in an older
tree (copy the script there). Needs one CUDA card; imports neither jax
nor defer_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402

SHAPES = {
    "bert": ((16, 12, 128, 64), False),
    "vit": ((32, 12, 197, 64), False),
    "gpt2_causal": ((4, 12, 512, 64), True),
}
# (old, new) text replacements of flash_attention.cu, each of which must
# match exactly once; HEADER_SKELETON's are of attn_wgmma.cuh (the products
# of wg::Acc).
SKELETON = [
    ("wg::fast_exp2(fmaf(s[e], prm.scale, shift[(e / 2) % 2]))",
     "fmaf(s[e], prm.scale, shift[(e / 2) % 2])"),
]
HEADER_SKELETON = [
    ("      ss<T>(s, dq[kk], dk[kk], kk > 0);\n", ""),
    ("      rs<T, kD>(o, p[kBuf][kk], dv[kk]);\n", ""),
]
STAMP_DEFS = r"""
namespace {
constexpr int kStampSlots = 16;  // per CTA: phases 0-13, the SM in 15
__device__ unsigned long long fa_stamps[1 << 21];
}
#define STAMP(i)                                                         \
  if (threadIdx.x == 0 && (i) < kStampSlots - 1) {                       \
    unsigned long long t_;                                               \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
    fa_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * kStampSlots + (i)] = \
        t_;                                                              \
  }
"""
STAMP_EXPORTS = r"""
extern "C" int defer_flash_attention_stamps(void* host, long long n) {
  return int(cudaMemcpyFromSymbol(host, fa_stamps, n * 8));
}
extern "C" int defer_flash_attention_clear_stamps() {
  static unsigned long long zeros[1 << 21];
  return int(cudaMemcpyToSymbol(fa_stamps, zeros, sizeof(zeros)));
}
"""
STAMPS = [
    ('#include "attn_wgmma.cuh"\n', '#include "attn_wgmma.cuh"\n' + STAMP_DEFS),
    ("  const bool leader = threadIdx.x == 0;\n",
     "  const bool leader = threadIdx.x == 0;\n  STAMP(0);\n"
     "  if (leader) {\n    unsigned sm;\n"
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "    fa_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * kStampSlots +\n"
     "              kStampSlots - 1] = sm;\n  }\n"),
    ("  wg::mbar_wait(k_full, 0);\n", "  wg::mbar_wait(k_full, 0);\n  STAMP(1);\n"),
    ("  release(&tk, ks, k_full, k_empty, 0);\n",
     "  STAMP(2);\n  release(&tk, ks, k_full, k_empty, 0);\n"),
    ("  rows.template softmax<0>(0, q0, row0, lane, prm);\n",
     "  rows.template softmax<0>(0, q0, row0, lane, prm);\n  STAMP(3);\n"),
    ("    rows.template softmax<1 - kPrev>",
     "    STAMP(2 + 2 * t);\n    rows.template softmax<1 - kPrev>"),
    ("    release(&tv, vs, v_full, v_empty, t - 1);\n",
     "    release(&tv, vs, v_full, v_empty, t - 1);\n    STAMP(3 + 2 * t);\n"),
    ("  wg::hold(rows.o);\n\n", "  wg::hold(rows.o);\n  STAMP(12);\n\n"),
    ("    wg::tma_store_commit_and_drain();\n  }\n}\n",
     "    wg::tma_store_commit_and_drain();\n  }\n  STAMP(13);\n}\n"),
]
VARIANTS = {"default": [], "skeleton": SKELETON, "stamps": STAMPS}
PHASES = {1: "Q and K 0 landed", 2: "scores of tile 0", 3: "softmax of 0",
          4: "products of 1", 5: "softmax of 1", 6: "products of 2",
          7: "softmax of 2", 8: "products of 3", 9: "softmax of 3",
          12: "last P V", 13: "store"}


def _replaced(source: str, patches) -> str:
    for old, new in patches:
        if source.count(old) != 1:
            raise RuntimeError(f"patch target not found once: {old!r}")
        source = source.replace(old, new)
    return source


def _patched(source: str, patches) -> str:
    return _replaced(source, patches) + (STAMP_EXPORTS if patches is STAMPS
                                         else "")


def _build(name: str, patches, out_dir: str):
    """The source (and the engine header, patched for the skeleton) built
    in a directory of its own under `out_dir`."""
    from defer_tpu_torch.utils import nvcc

    work = os.path.join(out_dir, name)
    os.makedirs(work)
    header = (nvcc.CSRC / "attn_wgmma.cuh").read_text()
    if patches is SKELETON:
        header = _replaced(header, HEADER_SKELETON)
    with open(os.path.join(work, "attn_wgmma.cuh"), "w") as f:
        f.write(header)
    src = os.path.join(work, f"fa_{name}.cu")
    with open(src, "w") as f:
        f.write(_patched((nvcc.CSRC / "flash_attention.cu").read_text(),
                         patches))
    out = os.path.join(work, f"libfa_{name}.so")
    proc = subprocess.run(
        [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
         src],
        capture_output=True, text=True,
    )
    return name, proc.returncode, out, proc.stdout + proc.stderr


def _entry(lib):
    fn = lib.defer_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _prepared(fn, q, k, v, causal):
    """A call of the C entry on fixed arguments and output, built once."""
    import torch

    from defer_tpu_torch.ops.flash_attention import launch_plan

    b, h, s_q, dh = q.shape
    plan = launch_plan(s_q, k.shape[2], dh, causal)
    out = torch.empty((b, s_q, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(
        t.stride(i) for t in (q, k, v, out) for i in range(3)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2,
            b, h, s_q, k.shape[2], dh, strides, dh**-0.5, int(causal),
            plan.panels, plan.q_tiles, plan.k_tiles,
            int(plan.heaviest_first), q.device.index,
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    return call


def _stamps(lib, fn, q, k, v, causal) -> None:
    import numpy as np
    import torch

    lib.defer_flash_attention_stamps.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_longlong]
    call = _prepared(fn, q, k, v, causal)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.defer_flash_attention_clear_stamps()
    call()
    torch.cuda.synchronize()
    b, h, s, _ = q.shape
    n_cta = b * h * -(-s // 64)
    buf = np.zeros(n_cta * 16, dtype=np.uint64)
    lib.defer_flash_attention_stamps(buf.ctypes.data, buf.size)
    st = buf.reshape(n_cta, 16).astype(np.int64)
    span = st[:, 13].max() - st[:, 0].min()
    life = st[:, 13] - st[:, 0]
    print(f"    {n_cta} CTAs over {span / 1e3:.2f} us; a CTA lives "
          f"{np.median(life) / 1e3:.2f} us (median)")
    prev = 0
    for col in sorted(PHASES):
        if not (st[:, col] > 0).all():
            continue
        d = st[:, col] - st[:, prev]
        print(f"    {PHASES[col]:18s} {np.median(d):7.0f} ns median, "
              f"{np.percentile(d, 90):7.0f} p90")
        prev = col
    resident = []
    for sm in np.unique(st[:, 15]):
        rows = st[st[:, 15] == sm]
        events = sorted([(r[0], 1) for r in rows]
                        + [(r[13], -1) for r in rows])
        now = most = 0
        for _, step in events:
            now += step
            most = max(most, now)
        resident.append(most)
    print(f"    CTAs resident per SM at most: {np.bincount(resident)} "
          "(index = count, value = SMs)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the wrapper's times only (any tree)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from defer_tpu_torch.ops.flash_attention import flash_attention

    print(chip_smoke.card_line(), torch.__version__, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {key: chip_smoke._bert_qkv(gen, *shape, torch.bfloat16)
              for key, (shape, _) in SHAPES.items()}
    for key, (shape, causal) in SHAPES.items():
        q, k, v = inputs[key]
        kernel = chip_smoke.cuda_time_ms(
            lambda: flash_attention(q, k, v, causal=causal))
        sdpa = chip_smoke.cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        host = chip_smoke.host_time_us(
            lambda: flash_attention(q, k, v, causal=causal), iters=300)
        print(f"{key} {shape} causal={causal}: kernel_ms {kernel:.5f} "
              f"sdpa_ms {sdpa:.5f} host_us_a_call {host:.2f}", flush=True)
    if args.quick:
        return 0

    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(lambda kv: _build(*kv, tmp),
                                  VARIANTS.items()))
        libs = {}
        for name, rc, path, log in built:
            notes = sorted(set(re.sub(r"line \d+", "line N", n) for n in
                               re.findall(r"\(C75\d\d\)[^']*", log)))
            regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
            print(f"variant {name}: nvcc rc {rc}, registers {regs}",
                  flush=True)
            for note in notes:
                print(f"  ptxas {note.strip()[:150]}")
            if rc:
                print(log[-3000:])
                continue
            libs[name] = ctypes.CDLL(path)
        for name in ("default", "skeleton"):
            if name not in libs:
                continue
            fn = _entry(libs[name])
            for key, (shape, causal) in SHAPES.items():
                ms = chip_smoke.cuda_time_ms(
                    _prepared(fn, *inputs[key], causal))
                print(f"variant {name} {key}: kernel_ms {ms:.5f}", flush=True)
            if name == "default":
                host = chip_smoke.host_time_us(
                    _prepared(fn, *inputs["bert"], False), iters=300)
                print(f"variant default bert: host_us_a_call of the C entry "
                      f"alone (4 maps encoded, one launch) {host:.2f}",
                      flush=True)
        if "stamps" in libs:
            fn = _entry(libs["stamps"])
            for key in ("vit", "bert"):
                print(f"stamps {key}:")
                _stamps(libs["stamps"], fn, *inputs[key], SHAPES[key][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
