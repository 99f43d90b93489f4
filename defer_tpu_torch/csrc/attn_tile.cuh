// The tensor-core attention tile shared by flash_attention.cu and
// paged_flash_prefill.cu (sm_90a): one CTA of 4 warps owns 64 query rows,
// each warp 16 of them, and walks 64-column K/V tiles that sit in shared
// memory as 16-bit rows (bf16 or f16, q's type).
//
//   * S = Q K^T and O += P V are mma.sync.m16n8k16 with 16-bit operands and
//     f32 accumulation. Q is loaded once into registers as A fragments
//     (ldmatrix); K tiles feed B fragments through ldmatrix, V tiles through
//     ldmatrix.trans, so neither is transposed in memory.
//   * S stays in the accumulator registers. The online softmax runs on them
//     in f32 in the log2 domain (the caller multiplies S by Dh^-0.5 * log2(e),
//     per column when an int8 pool's K scale is folded in); row max and row
//     sum reduce across the 4 threads of a row with two shfl_xor each.
//   * P is rounded to q's 16-bit type in registers and is the A fragment of
//     P V as it stands: the m16n8 accumulator layout of two adjacent 8-column
//     S tiles is the m16k16 A layout. P makes no trip through shared memory.
//   * A shared-memory row is kD + 8 elements: the 16-byte pad puts the 8 rows
//     of every ldmatrix 8x8 matrix in 8 different bank groups.
//
// Numerics: both products take 16-bit operands with f32 accumulation, and P
// is rounded before P V (at most 2^-9 relative for bf16). The TPU kernel's
// f32 dots run as one bf16 MXU pass at default precision, which rounds its
// operands the same way.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + i; an A fragment
// holds rows g and g + 8, columns 2i, 2i + 1 and 2i + 8, 2i + 9; a B fragment
// columns (n) g, rows (k) 2i, 2i + 1 and 2i + 8, 2i + 9; the accumulator
// rows g and g + 8, columns 2i and 2i + 1.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace tile {

constexpr int kRows = 64;  // query rows of a CTA
constexpr int kCols = 64;  // key columns of a K/V tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
// Finite stand-in for -inf, as _MASK_VALUE in the TPU kernels.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without a register stop; `bytes`
// 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-bit operand type: its mma and how two f32 values pack into it.
template <typename T>
struct Op;

template <>
struct Op<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};

template <>
struct Op<__half> {
  using Pair = __half2;
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const typename Op<T>::Pair h = Op<T>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One warp's 16 query rows. kD is the register width of the head dim (a
// multiple of 16); `nk` = Dp / 16 of it is used, Dp the head dim padded to
// 16 (the padding columns are zeros in shared memory).
template <typename T, int kD>
struct Rows {
  static constexpr int ld = kD + 8;  // shared-memory row, in elements
  uint32_t q[kD / 16][4];            // A fragments of Q
  float o[kD / 8][4];                // O, accumulator layout
  float m[2];                        // row max of rows g, g + 8 (log2 domain)
  float l[2];                        // this thread's share of the row sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = kMaskValue;
    l[0] = l[1] = 0.f;
  }

  // Q rows 16 * warp .. + 15 of a [kRows][ld] tile into A fragments.
  __device__ __forceinline__ void load_q(const T* qs, int warp, int lane,
                                         int nk) {
    const T* base = qs + (16 * warp + (lane % 16)) * ld + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      if (kk < nk) ldsm_x4(q[kk], base + kk * 16);
    }
  }

  // s = Q K^T for the 64 key rows of the [kCols][ld] tile `ks`; s[n] holds
  // columns 8n + 2i, 8n + 2i + 1 of rows g (s[n][0..1]) and g + 8 (s[n][2..3]).
  __device__ __forceinline__ void scores(const T* ks, int lane, int nk,
                                         float (&s)[kCols / 8][4]) const {
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const T* base =
        ks + ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int j = 0; j < kCols / 16; ++j) {
          uint32_t b[4];
          ldsm_x4(b, base + 16 * j * ld + kk * 16);
          Op<T>::mma(s[2 * j], q[kk], b[0], b[1]);
          Op<T>::mma(s[2 * j + 1], q[kk], b[2], b[3]);
        }
      }
    }
  }

  // The online-softmax step on scores already in the log2 domain and
  // masked: new row max over the quad, rescale of l and O, s -> exp2(s - m).
  __device__ __forceinline__ void softmax(float (&s)[kCols / 8][4]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(s[n][e] - mx[e / 2]);
        sum[e / 2] += s[n][e];
      }
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
  }

  // O += P V for the probabilities p (rounded to T here) and the 64 value
  // rows of the [kCols][ld] tile `vs`.
  __device__ __forceinline__ void accumulate(const float (&p)[kCols / 8][4],
                                             const T* vs, int lane, int nk) {
    const T* base =
        vs + ((lane % 8) + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      const uint32_t a[4] = {
          pack<T>(p[2 * kk][0], p[2 * kk][1]),
          pack<T>(p[2 * kk][2], p[2 * kk][3]),
          pack<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack<T>(p[2 * kk + 1][2], p[2 * kk + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kD / 16; ++j) {
        if (j < nk) {
          uint32_t b[4];
          ldsm_x4_trans(b, base + 16 * kk * ld + 16 * j);
          Op<T>::mma(o[2 * j], a, b[0], b[1]);
          Op<T>::mma(o[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // The full row sums of rows g and g + 8 (the quad's shares added).
  __device__ __forceinline__ void row_sums(float (&out)[2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      out[r] = x;
    }
  }
};

}  // namespace tile
