// Paged flash prefill for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel
// defer_tpu/ops/pallas_attention.py::paged_flash_prefill (body
// _paged_prefill_kernel, live range _prefill_lo_hi): T query tokens per slot,
// q [B, Hq, T, Dh] at absolute positions start[b] .. start[b] + T - 1,
// against ONE layer of the paged KV pool, pool [NB, Hkv, bs, Dh], through the
// slot's block table [B, MB] (row r of slot b is row r % bs of pool block
// tables[b, r / bs]); the window's own K/V rows are already in the pool.
// Query rows are token-major: row r of a KV head's T*G rows is token r / G
// of query head kvh * G + r % G, and attends the columns <= start + r / G
// (and > start + r / G - window with a window). q pre-scaled by Dh^-0.5 in
// f32, f32 m/l/acc per row with the same finite mask value, output acc / l
// cast to q's dtype. The pool is q's dtype, or int8 with one f32 scale per
// (block, KV head), scale_k/scale_v [NB, Hkv] (the TPU kernel's `quantized`
// path).
//
// What bounds it on an H100: the live pool rows and q/o, each moved once;
// at a 64-token chunk the products are a few MFLOP a head.
//
// Design (defer_tpu_torch/csrc/flash_attention.cu's, plus the indirection):
//   * one thread block = one (32-row tile of the T*G token-major query rows,
//     KV head, slot); blocks run in any order, the walk over the pool is a
//     loop inside the block (32 rows, not flash_attention's 64: a 64-token
//     chunk of one slot is then 64 blocks, not 32);
//   * the block reads start[b] on the card and walks only the live columns
//     of its own rows, from the edge of the first live block
//     (_prefill_lo_hi) through the deepest row's position, 64 columns a
//     tile; the first 64 threads resolve each tile column's pool address
//     through the table, then the block stages the tile's K and V rows in
//     shared memory as f32, rows padded to Dh+1 floats, in 16-byte loads
//     issued a batch at a time (one element per load left the block
//     waiting on memory latency: a tile cost more to load than to use);
//   * 4 threads own one query row: each computes 16 of the tile's 64 scores
//     and Dh/4 of the row's output columns; each row masks causally at its
//     own position; row max and row sum combine with two warp shuffles;
//   * rows padded past T*G compute on zeros and are never written;
//   * both products are f32 FMAs, as the TPU kernel casts to f32 before its
//     dots; q and o are read and written through (b, h, t) strides with a
//     unit Dh stride; Dh is 32, 64 or 128, rows 16-byte aligned;
//   * an int8 pool is staged from int8 (16 columns a 16-byte load) and
//     widened as it lands in shared memory, times a per-row multiplier: the
//     scale of that tile row's pool block for this KV head, which the first
//     64 threads read beside the row's table entry. Columns past the live
//     range read neither payload nor scale.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;
constexpr int kLanes = 4;  // threads per query row
constexpr int kThreads = kBlockQ * kLanes;
constexpr int kCols = kBlockK / kLanes;  // scores per thread per K tile
// Finite stand-in for -inf, as _MASK_VALUE in the TPU kernel.
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;  // pool [NB, Hkv, bs, Dh] of one layer
  const void* v;
  void* o;
  const int* tables;  // [B, MB]
  const float* sk;    // int8 pool: scales [NB, Hkv]; null otherwise
  const float* sv;
  const int* start;
  long long start_stride;  // 0 broadcasts one start to the batch
  long long qb, qh, qt;    // element strides; the Dh stride is 1
  long long kn, kh, ks;    // pool: block, head, row
  long long vn, vh, vs;
  long long tb;            // tables: slot
  long long ob, oh, ot;
  long long skn, skh;      // scales: block, head
  long long svn, svh;
  int group, t_q, bs, mb, dh, window;
  float scale;
};

// Stages kRowsT rows of kDh elements into shared memory as f32, times
// row_mul[c] for row c (or `mul` for every row where row_mul is null): row c
// lies at src + off[c], or is zeros where off[c] < 0. Each thread starts
// kBatch 16-byte loads before it converts and stores any, so the loads of a
// tile are in flight together.
template <typename T, int kDh, int kRowsT>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           const long long* off,
                                           const float* row_mul, float* dst,
                                           int ld, float mul, int tid) {
  constexpr int kChunk = 16 / int(sizeof(T));  // elements per load
  constexpr int kCpr = kDh / kChunk;           // loads per row
  constexpr int kTotal = kRowsT * kCpr;
  constexpr int kBatch = 4;
  for (int base = 0; base < kTotal; base += kThreads * kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads + tid;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kTotal) {
        const long long o = off[idx / kCpr];
        if (o >= 0) {
          raw[u] = *reinterpret_cast<const uint4*>(src + o +
                                                   (idx % kCpr) * kChunk);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx < kTotal) {
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
        const float f = row_mul != nullptr ? row_mul[idx / kCpr] : mul;
        float* d = dst + (idx / kCpr) * ld + (idx % kCpr) * kChunk;
#pragma unroll
        for (int e = 0; e < kChunk; ++e) d[e] = to_f32(vals[e]) * f;
      }
    }
  }
}

// T: q and o; P: the pool, T or int8_t (then scaled by p.sk / p.sv).
template <typename T, typename P, int kDh>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(Params p) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  extern __shared__ float smem[];
  constexpr int ld = kDh + 1;
  float* qs = smem;                 // [kBlockQ][ld]
  float* ks = qs + kBlockQ * ld;    // [kBlockK][ld]
  float* vs = ks + kBlockK * ld;    // [kBlockK][ld]
  float* ps = vs + kBlockK * ld;    // [kBlockQ][kBlockK + 1]
  // Element offsets of the tile's K and V rows in the pool and of the
  // block's q rows (-1: none). The float count before them is even, so
  // they are 8-byte aligned.
  long long* koff = reinterpret_cast<long long*>(ps + kBlockQ * (kBlockK + 1));
  long long* voff = koff + kBlockK;
  long long* qoff = voff + kBlockK;
  // The tile rows' block scales (int8 pool).
  float* kmul = reinterpret_cast<float*>(qoff + kBlockQ);
  float* vmul = kmul + kBlockK;

  const int r0 = blockIdx.x * kBlockQ;  // first token-major row
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = p.t_q * p.group;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int start = p.start[b * p.start_stride];
  const int qpos = start + (r0 + row) / p.group;  // this row's position

  if (tid < kBlockQ) {
    const int r = r0 + tid;
    qoff[tid] = r < rows ? (kvh * p.group + r % p.group) * p.qh +
                               (long long)(r / p.group) * p.qt
                         : -1;
  }
  __syncthreads();
  stage_rows<T, kDh, kBlockQ>(static_cast<const T*>(p.q) + b * p.qb, qoff,
                              nullptr, qs, ld, p.scale, tid);

  // The live columns of this block's rows: from the edge of the block that
  // holds the first row's window start through the last row's position.
  const int t_first = r0 / p.group;
  const int t_last = min((r0 + kBlockQ - 1) / p.group, p.t_q - 1);
  const int hi = min(start + t_last, p.mb * p.bs - 1);
  const int lo = p.window > 0 ? max(start + t_first - p.window + 1, 0) : 0;
  const int c0 = lo / p.bs * p.bs;

  float m = kMaskValue;
  float l = 0.f;
  float acc[kDh / kLanes];
#pragma unroll
  for (int i = 0; i < kDh / kLanes; ++i) acc[i] = 0.f;

  const int* table = p.tables + b * p.tb;
  const P* k = static_cast<const P*>(p.k) + kvh * p.kh;
  const P* v = static_cast<const P*>(p.v) + kvh * p.vh;
  const float* qr = qs + row * ld;
  float* pr = ps + row * (kBlockK + 1);

  for (int k0 = c0; k0 <= hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile's reads of ks/vs/offsets are done
    if (tid < kBlockK) {
      const int col = k0 + tid;
      if (col <= hi) {
        const int tcol = col / p.bs;
        const long long blk = __ldg(table + tcol);
        const long long r = col - tcol * p.bs;
        koff[tid] = blk * p.kn + r * p.ks;
        voff[tid] = blk * p.vn + r * p.vs;
        if constexpr (kQuant) {
          kmul[tid] = __ldg(p.sk + blk * p.skn + kvh * p.skh);
          vmul[tid] = __ldg(p.sv + blk * p.svn + kvh * p.svh);
        }
      } else {
        koff[tid] = voff[tid] = -1;
        if constexpr (kQuant) kmul[tid] = vmul[tid] = 0.f;
      }
    }
    __syncthreads();
    stage_rows<P, kDh, kBlockK>(k, koff, kQuant ? kmul : nullptr, ks, ld, 1.f,
                                tid);
    stage_rows<P, kDh, kBlockK>(v, voff, kQuant ? vmul : nullptr, vs, ld, 1.f,
                                tid);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] = fmaf(qd, ks[(lane + j * kLanes) * ld + d], s[j]);
      }
    }

    float m_new = m;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = k0 + lane + j * kLanes;
      if (col > hi) {
        s[j] = -INFINITY;  // past the live columns: weighs exactly 0
      } else if (col > qpos || (p.window > 0 && col <= qpos - p.window)) {
        s[j] = kMaskValue;
      }
      m_new = fmaxf(m_new, s[j]);
    }
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));

    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
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
    for (int i = 0; i < kDh / kLanes; ++i) acc[i] *= alpha;
    const int live = min(kBlockK, hi - k0 + 1);
    for (int c = 0; c < live; ++c) {
      const float pc = pr[c];
      const float* vr = vs + c * ld;
#pragma unroll
      for (int i = 0; i < kDh / kLanes; ++i) {
        acc[i] = fmaf(pc, vr[lane + i * kLanes], acc[i]);
      }
    }
  }

  const int r = r0 + row;
  if (r < rows) {
    const int h = kvh * p.group + r % p.group;
    T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh +
           (long long)(r / p.group) * p.ot;
#pragma unroll
    for (int i = 0; i < kDh / kLanes; ++i) {
      o[lane + i * kLanes] = from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, typename P, int kDh>
cudaError_t launch(const Params& p, int batch, int hkv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(kBlockQ + 2 * kBlockK) * (kDh + 1) +
                       size_t(kBlockQ) * (kBlockK + 1)) +
      sizeof(long long) * (2 * kBlockK + kBlockQ) +
      sizeof(float) * 2 * kBlockK;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, P, kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = p.t_q * p.group;
  const dim3 grid((rows + kBlockQ - 1) / kBlockQ, hkv, batch);
  paged_prefill_kernel<T, P, kDh><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_dh(const Params& p, int batch, int hkv,
                      cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch<T, P, 32>(p, batch, hkv, stream);
    case 64: return launch<T, P, 64>(p, batch, hkv, stream);
    case 128: return launch<T, P, 128>(p, batch, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The pool is q's type, or int8 with scales.
template <typename T>
cudaError_t launch_pool(const Params& p, bool int8_pool, int batch, int hkv,
                        cudaStream_t stream) {
  return int8_pool ? launch_dh<T, int8_t>(p, batch, hkv, stream)
                   : launch_dh<T, T>(p, batch, hkv, stream);
}

}  // namespace

// dtype (q and o): 0 = float32, 1 = float16, 2 = bfloat16; pool_dtype: the
// same code as dtype, or 3 = int8, which needs scale_k / scale_v, f32
// [NB, Hkv] on the device. tables: int32 [B, MB] on the device; start:
// int32 on the device, start_stride 1 for one start per slot or 0 to
// broadcast one. strides: 17 element strides, (b, h, t) of q, (block, h,
// row) of pool_k, (block, h, row) of pool_v, b of tables, (b, h, t) of o,
// (block, h) of scale_k, (block, h) of scale_v (unused for a float pool).
// window <= 0 means no window. Returns a cudaError_t value; 0 means
// launched.
extern "C" int defer_paged_flash_prefill(
    const void* q, const void* pool_k, const void* pool_v, void* o,
    const int* tables, const float* scale_k, const float* scale_v,
    const int* start, long long start_stride, int dtype, int pool_dtype,
    int batch, int hq, int hkv, int t_q, int bs, int mb, int dh,
    const long long* strides, int window, float scale, void* stream) {
  const bool int8_pool = pool_dtype == 3;
  if (batch < 1 || hkv < 1 || hq < hkv ||
      hq % hkv || t_q < 1 || bs < 1 || mb < 1 || batch > 65535 ||
      hkv > 65535 || (pool_dtype != dtype && !int8_pool) ||
      (int8_pool && (scale_k == nullptr || scale_v == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = pool_k;
  p.v = pool_v;
  p.o = o;
  p.tables = tables;
  p.sk = scale_k;
  p.sv = scale_v;
  p.start = start;
  p.start_stride = start_stride;
  p.qb = strides[0];
  p.qh = strides[1];
  p.qt = strides[2];
  p.kn = strides[3];
  p.kh = strides[4];
  p.ks = strides[5];
  p.vn = strides[6];
  p.vh = strides[7];
  p.vs = strides[8];
  p.tb = strides[9];
  p.ob = strides[10];
  p.oh = strides[11];
  p.ot = strides[12];
  p.skn = strides[13];
  p.skh = strides[14];
  p.svn = strides[15];
  p.svh = strides[16];
  p.group = hq / hkv;
  p.t_q = t_q;
  p.bs = bs;
  p.mb = mb;
  p.dh = dh;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_pool<float>(p, int8_pool, batch, hkv, st));
    case 1: return int(launch_pool<__half>(p, int8_pool, batch, hkv, st));
    case 2:
      return int(launch_pool<__nv_bfloat16>(p, int8_pool, batch, hkv, st));
    default: return int(cudaErrorInvalidValue);
  }
}
