// The Hopper attention engine of flash_attention.cu and
// paged_flash_prefill.cu (sm_90a): tiles come into shared memory by TMA,
// the products run on wgmma, and a consumer warpgroup of 128 threads owns
// 64 query rows (wgmma's M).
//
//   * Tiles are 64 rows by 64 head-dim columns of 16-bit values (bf16 or
//     f16, q's type): one TMA box of 128-byte rows in the 128-byte swizzle
//     (8 KB, 1024-byte aligned). A head dim over 64 takes two boxes, the
//     "panels" of columns 0-63 and 64-127. TMA zero-fills what lies past
//     the tensor: the ragged rows of the last tile and the columns from
//     Dh up to the panel's 64.
//   * S = Q K^T is wgmma m64n64k16 with A = Q and B = K both read from
//     shared memory, K-major (Dh contiguous), one instruction per 16
//     columns of Dh, N = 64 keys. The descriptor of k-step kk starts
//     kk * 32 bytes into the 128-byte row (a panel further every 4 steps).
//   * O += P V is wgmma m64nDk16 with A = P in registers and B = V read
//     from shared memory in its MN-major form (V's rows are keys, Dh
//     contiguous: the transposed-B flag), one instruction per 16 keys,
//     2048 bytes apart; the leading byte offset steps between panels.
//   * The f32 accumulators of S are the online softmax's input in place;
//     P is rounded to q's type in registers, and the accumulator layout of
//     columns 16kk..16kk+15 is the A-fragment layout of k-step kk.
//
// Register layouts (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup
// holds rows 16w..16w+15; lane = 4g + i; accumulator d[4j + e] is row
// 16w + g + 8 * (e / 2), column 8j + 2i + e % 2; an A fragment of 16
// columns holds the same rows at columns 2i, 2i + 1 (registers 0, 1) and
// 2i + 8, 2i + 9 (registers 2, 3).

#pragma once

#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace wg {

constexpr int kRows = 64;                    // query rows of a warpgroup
constexpr int kCols = 64;                    // key columns of a full tile
constexpr int kPanel = 64;                   // head-dim columns of a box
constexpr int kBoxBytes = kRows * kPanel * 2;  // one 128-byte-swizzled box
constexpr int kRowBytes = kPanel * 2;
// Finite stand-in for -inf, as _MASK_VALUE in the TPU kernels.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one register of q's 16-bit type, `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two values of q's 16-bit type in a register as f32, `lo` first.
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
template <>
__device__ __forceinline__ float2 unpack<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Arrives once and adds `bytes` to the transaction count of the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the phase of parity `parity` has completed (a barrier's
// phase 0 is the first; parity 1 before it passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// Brings a tensor map's descriptor into the TMA unit's cache ahead of its
// first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of the 4-D map (Dh, S, H, B) at (c0, c1, c2, c3) into shared
// memory; completes `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// One box from shared memory to the map; what lies past the tensor is not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Generic-proxy writes of shared memory before an async-proxy (TMA) read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// -- distributed shared memory --------------------------------------------

// The shared::cluster address of `p` (this CTA's shared memory) in the CTA
// of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program: the compiler may not move a
// read or write of them across it, so that nothing touches a wgmma's
// operands between its issue and the wait that retires it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint64_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// d (m64n64, f32) = or += A B with A and B in shared memory, both K-major.
template <typename T>
__device__ __forceinline__ void ss(float (&d)[kCols / 2], uint64_t a,
                                   uint64_t b, int scale_d);
// d (m64nN, f32) += A B with A in registers and B in shared memory,
// MN-major.
template <typename T, int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t b);

template <>
__device__ __forceinline__ void ss<__nv_bfloat16>(float (&d)[kCols / 2],
                                             uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void rs<__nv_bfloat16, 64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void rs<__nv_bfloat16, 128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void ss<__half>(float (&d)[kCols / 2],
                                             uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void rs<__half, 64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void rs<__half, 128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A consumer warpgroup's 64 query rows: this thread's share of O, the
// scores of the tile last issued, and the probabilities of two tiles in two
// buffers that tiles take in turn (the K loop unrolled by two), so that no
// softmax writes the registers of the P V issued just before it. Each
// kernel adds its softmax (its mask and scaling) and its epilogue.
template <typename T, int kPanels>
struct Acc {
  static constexpr int kD = kPanel * kPanels;
  static constexpr int kSteps = kD / 16;  // k-steps of Q K^T
  float o[kD / 2];
  float s[kCols / 2];
  uint32_t p[2][kCols / 16][4];  // P of tile t in buffer t % 2
  float m[2], l[2], alpha[2];    // rows g and g + 8

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) s[i] = 0.f;
    m[0] = m[1] = kMaskValue;
    l[0] = l[1] = 0.f;
    alpha[0] = alpha[1] = 0.f;
  }

  // Issues S = Q K^T as one wgmma group over every k-step of the panels
  // (the columns past Dh are zeros). The descriptors are built before the
  // fence.
  __device__ __forceinline__ void issue_qk(const unsigned char* q,
                                           const unsigned char* k) {
    uint64_t dq[kSteps], dk[kSteps];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      dq[kk] = desc(q + off, 16, 8 * kRowBytes);
      dk[kk] = desc(k + off, 16, 8 * kRowBytes);
    }
    hold(dq);
    hold(dk);
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ss<T>(s, dq[kk], dk[kk], kk > 0);
    }
    wgmma_commit();
  }

  // Issues O += P V (P from buffer kBuf) over the tile's 64 keys as one
  // wgmma group.
  template <int kBuf>
  __device__ __forceinline__ void issue_pv(const unsigned char* v) {
    uint64_t dv[kCols / 16];
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      dv[kk] = desc(v + 16 * kk * kRowBytes, kBoxBytes, 8 * kRowBytes);
    }
    hold(dv);
    hold(o);
    hold(p[kBuf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      rs<T, kD>(o, p[kBuf][kk], dv[kk]);
    }
    wgmma_commit();
  }

  // P of buffer 1 into buffer 0.
  __device__ __forceinline__ void move_p() {
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[0][kk][e] = p[1][kk][e];
    }
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
};

// -- host ------------------------------------------------------------------

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (the attribute is per device): later launches skip the call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (set.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set.fetch_or(bit, std::memory_order_release);
  return err;
}

// A driver function found through the runtime (no -lcuda), or null.
template <typename Fn>
Fn driver_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &ptr, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<Fn>(ptr)
             : nullptr;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
using CtxGetCurrent = CUresult (*)(CUcontext*);

// Makes `device` current for a launch and sets `restore` to the device to
// make current again after it (restore != device). A thread with a
// current context keeps its device; one with none yet (a serving thread
// whose tensors came from PyTorch's cache), whose cudaGetDevice would say
// 0 whatever card it works on, is left on `device`, whose primary context
// the driver's tensor-map encode needs.
inline cudaError_t enter_device(int device, int& restore) {
  static const CtxGetCurrent ctx_current =
      driver_entry<CtxGetCurrent>("cuCtxGetCurrent");
  CUcontext ctx = nullptr;
  if (ctx_current == nullptr || ctx_current(&ctx) != CUDA_SUCCESS) {
    return cudaErrorInitializationError;
  }
  restore = device;
  cudaError_t err;
  if (ctx != nullptr && (err = cudaGetDevice(&restore)) != cudaSuccess) {
    return err;
  }
  if (ctx == nullptr || restore != device) return cudaSetDevice(device);
  return cudaSuccess;
}

}  // namespace wg
