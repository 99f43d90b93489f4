// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel defer_tpu/ops/pallas_attention.py::_flash_fwd_impl
// (body _mha_kernel): softmax(q k^T * Dh^-0.5) v on (B, H, S, Dh) tensors,
// online softmax over K tiles with f32 m/l/acc, optional causal mask with the
// same finite mask value, output acc / l cast to q's dtype.
//
// What bounds it on an H100: at BERT-base's shape (16, 12, 128, 64) bf16 the
// call moves 12.6 MB and does 0.81 GFLOP: bytes (3.8 us) over tensor-core
// operations (0.8 us). The products belong on the tensor cores; on the CUDA
// cores' f32 FMAs they cost about 30x as much and set the time.
//
// Design for bf16 / f16 q, k, v (attn_tile.cuh has the tile engine):
//   * one CTA = one (batch*head, 64-row q tile), 4 warps of 16 q rows; the
//     K/V walk is a loop inside the CTA;
//   * q, K and V tiles are copied into shared memory in their own 16-bit
//     type by cp.async (16 bytes a copy), K/V double-buffered: tile t + 1
//     is in flight while tile t computes;
//   * S = Q K^T and O += P V on mma.sync m16n8k16 with f32 accumulation;
//     S is scaled by Dh^-0.5 (times log2 e) in f32, not folded into q,
//     since Dh^-0.5 is not exact at every Dh;
//   * causal: only the K tiles inside the triangle are visited; only the
//     diagonal tile and a ragged last tile are masked, full tiles take no
//     per-element test;
//   * any S >= 1; Dh a multiple of 8 up to 128, zero-padded in shared memory
//     to the next 16 (Dh 40 and 72 compute as 48 and 80);
//   * inputs are read through (b, h, s) strides with a unit Dh stride, so
//     the head split of a (B, S, H*Dh) projection is a view, not a copy
//     (rows 16-byte aligned, which the wrapper checks).
//
// f32 q, k, v keep an f32 FMA loop (flash_fwd_f32 below), chosen by dtype in
// defer_flash_attention_fwd. The tensor cores take f32 only as TF32 (about
// 3 decimal digits), which misses the f32 tolerance of 1e-5; no card path
// runs f32. Its layout: 4 threads a q row, K/V tiles staged as f32 rows of
// Dh + 1 floats, probabilities through shared memory.

#include <cmath>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace {

using tile::kCols;
using tile::kMaskValue;
using tile::kRows;
using tile::kThreads;

struct Strides {
  long long b, h, s;  // in elements; the Dh stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, s_q, s_k, dh;
  float scale;
  int causal;
};

// Rows [r0, r0 + 64) of a strided (s, Dh) matrix into a [64][ld] tile by
// cp.async; rows past n and columns in [Dh, Dp) are zeros, columns past Dp
// are never read.
template <typename T, int kD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int r0, int n, int dh, int dp,
                                      int tid) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks of a row
  constexpr int ld = tile::Rows<T, kD>::ld;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (c < dp) {
      const bool in = r0 + r < n && c < dh;
      tile::cp_async16(dst + r * ld + c,
                       in ? src + (r0 + r) * stride + c : src, in ? 16 : 0);
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(Params p) {
  using Rows = tile::Rows<T, kD>;
  constexpr int ld = Rows::ld;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kRows][ld]
  T* kbuf = qs + kRows * ld;           // [2][kCols][ld]
  T* vbuf = kbuf + 2 * kCols * ld;     // [2][kCols][ld]

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dp = (p.dh + 15) / 16 * 16;
  const int nk = dp / 16;

  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  int num_k = (p.s_k + kCols - 1) / kCols;
  if (p.causal) num_k = min(num_k, (q0 + kRows + kCols - 1) / kCols);

  stage<T, kD>(qs, q, p.sq.s, q0, p.s_q, p.dh, dp, tid);
  stage<T, kD>(kbuf, k, p.sk.s, 0, p.s_k, p.dh, dp, tid);
  stage<T, kD>(vbuf, v, p.sv.s, 0, p.s_k, p.dh, dp, tid);
  tile::cp_async_commit();

  Rows rows;
  rows.init();
  const float scale = p.scale * tile::kLog2e;
  // This thread's two q rows (accumulator rows g and g + 8).
  const int row0 = q0 + 16 * warp + lane / 4;

  for (int t = 0; t < num_k; ++t) {
    const int k0 = t * kCols;
    if (t + 1 < num_k) {
      const int nb = (t + 1) % 2;
      stage<T, kD>(kbuf + nb * kCols * ld, k, p.sk.s, k0 + kCols, p.s_k,
                   p.dh, dp, tid);
      stage<T, kD>(vbuf + nb * kCols * ld, v, p.sv.s, k0 + kCols, p.s_k,
                   p.dh, dp, tid);
    }
    tile::cp_async_commit();  // possibly empty: keeps the group count even
    tile::cp_async_wait<1>();  // tile t (and q) have landed
    __syncthreads();
    if (t == 0) rows.load_q(qs, warp, lane, nk);

    float s[kCols / 8][4];
    rows.scores(kbuf + (t % 2) * kCols * ld, lane, nk, s);
    const bool ragged = k0 + kCols > p.s_k;
    const bool diagonal = p.causal && k0 + kCols - 1 > q0;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }
    if (ragged || diagonal) {
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * (lane % 4) + (e % 2);
          const int row = row0 + 8 * (e / 2);
          if (col >= p.s_k) {
            s[n][e] = -INFINITY;  // ragged edge: weighs exactly 0
          } else if (p.causal && col > row) {
            s[n][e] = kMaskValue;
          }
        }
      }
    }
    rows.softmax(s);
    rows.accumulate(s, vbuf + (t % 2) * kCols * ld, lane, nk);
    __syncthreads();  // every warp is done with buffer t % 2
  }

  float l[2];
  rows.row_sums(l);
  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.s_q) {
      const float inv = 1.f / l[r];
      T* orow = o + row * p.so.s + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        if (8 * j < p.dh) {
          *reinterpret_cast<typename tile::Op<T>::Pair*>(orow + 8 * j) =
              tile::Op<T>::pair(rows.o[j][2 * r] * inv,
                                rows.o[j][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch_mma(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * size_t(kRows + 4 * kCols) * tile::Rows<T, kD>::ld;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.s_q + kRows - 1) / kRows);
  flash_fwd_mma<T, kD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_dh(const Params& p, int batch_heads,
                          cudaStream_t stream) {
  if (p.dh <= 32) return launch_mma<T, 32>(p, batch_heads, stream);
  if (p.dh <= 64) return launch_mma<T, 64>(p, batch_heads, stream);
  return launch_mma<T, 128>(p, batch_heads, stream);
}

// -- f32: the FMA loop ------------------------------------------------------

constexpr int kLanes = 4;  // threads per q row
constexpr int kF32Threads = kRows * kLanes;
constexpr int kF32Cols = kCols / kLanes;  // scores per thread per K tile

template <int kMaxDh>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(Params p) {
  extern __shared__ float fsmem[];
  const int dh = p.dh;
  const int ld = dh + 1;
  float* qs = fsmem;             // [kRows][ld]
  float* ks = qs + kRows * ld;   // [kCols][ld]
  float* vs = ks + kCols * ld;   // [kCols][ld]
  float* ps = vs + kCols * ld;   // [kRows][kCols + 1]

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int qrow = q0 + row;

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;

  for (int i = tid; i < kRows * dh; i += kF32Threads) {
    const int r = i / dh, d = i % dh;
    qs[r * ld + d] = q0 + r < p.s_q ? q[(q0 + r) * p.sq.s + d] * p.scale : 0.f;
  }

  float m = kMaskValue;
  float l = 0.f;
  float acc[kMaxDh / kLanes];
#pragma unroll
  for (int i = 0; i < kMaxDh / kLanes; ++i) acc[i] = 0.f;

  int num_k = (p.s_k + kCols - 1) / kCols;
  if (p.causal) {
    // Only the K tiles that meet this q tile's causal triangle.
    num_k = min(num_k, (q0 + kRows + kCols - 1) / kCols);
  }
  const float* qr = qs + row * ld;
  float* pr = ps + row * (kCols + 1);

  for (int t = 0; t < num_k; ++t) {
    const int k0 = t * kCols;
    __syncthreads();  // the previous tile's reads of ks/vs are done
    for (int i = tid; i < kCols * dh; i += kF32Threads) {
      const int r = i / dh, d = i % dh;
      const bool in = k0 + r < p.s_k;
      ks[r * ld + d] = in ? k[(k0 + r) * p.sk.s + d] : 0.f;
      vs[r * ld + d] = in ? v[(k0 + r) * p.sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[kF32Cols];
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) s[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) {
        s[j] = fmaf(qd, ks[(lane + j * kLanes) * ld + d], s[j]);
      }
    }

    float m_new = m;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = k0 + lane + j * kLanes;
      if (col >= p.s_k) {
        s[j] = -INFINITY;  // ragged edge: weighs exactly 0
      } else if (p.causal && col > qrow) {
        s[j] = kMaskValue;
      }
      m_new = fmaxf(m_new, s[j]);
    }
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));

    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const float e = expf(s[j] - m_new);
      psum += e;
      pr[lane + j * kLanes] = e;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's 4 threads share one warp

#pragma unroll
    for (int i = 0; i < kMaxDh / kLanes; ++i) acc[i] *= alpha;
    const int live = min(kCols, p.s_k - k0);
    for (int c = 0; c < live; ++c) {
      const float pc = pr[c];
      const float* vr = vs + c * ld;
#pragma unroll
      for (int i = 0; i < kMaxDh / kLanes; ++i) {
        const int d = lane + i * kLanes;
        if (d < dh) acc[i] = fmaf(pc, vr[d], acc[i]);
      }
    }
  }

  if (qrow < p.s_q) {
    float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h +
               qrow * p.so.s;
#pragma unroll
    for (int i = 0; i < kMaxDh / kLanes; ++i) {
      const int d = lane + i * kLanes;
      if (d < dh) o[d] = acc[i] / l;
    }
  }
}

template <int kMaxDh>
cudaError_t launch_f32(const Params& p, int batch_heads,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(3) * kRows * (p.dh + 1) +
                       size_t(kRows) * (kCols + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<kMaxDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.s_q + kRows - 1) / kRows);
  flash_fwd_f32<kMaxDh><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_dh(const Params& p, int batch_heads,
                          cudaStream_t stream) {
  if (p.dh <= 32) return launch_f32<32>(p, batch_heads, stream);
  if (p.dh <= 64) return launch_f32<64>(p, batch_heads, stream);
  return launch_f32<128>(p, batch_heads, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// strides: 12 element strides, (b, h, s) for q, k, v and o in that order;
// for float16 / bfloat16 every row must start on 16 bytes.
// Returns a cudaError_t value; 0 means the kernel was launched.
extern "C" int defer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int s_q, int s_k, int dh,
    const long long* strides, float scale, int causal, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 || s_q < 1 || s_k < 1 || batch < 1 ||
      heads < 1 || (causal && s_q != s_k) ||
      (long long)(s_q + kRows - 1) / kRows > 65535) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.heads = heads;
  p.s_q = s_q;
  p.s_k = s_k;
  p.dh = dh;
  p.scale = scale;
  p.causal = causal;
  const int bh = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_f32_dh(p, bh, st));
    case 1: return int(launch_mma_dh<__half>(p, bh, st));
    case 2: return int(launch_mma_dh<__nv_bfloat16>(p, bh, st));
    default: return int(cudaErrorInvalidValue);
  }
}
