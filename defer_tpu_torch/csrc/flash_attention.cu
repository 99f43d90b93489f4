// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel defer_tpu/ops/pallas_attention.py::_flash_fwd_impl
// (body _mha_kernel): softmax(q k^T * Dh^-0.5) v on (B, H, S, Dh) tensors,
// online softmax over K tiles with f32 m/l/acc, optional causal mask with the
// same finite mask value, output acc / l cast to q's dtype.
//
// Design (see defer_tpu_torch/ops/flash_attention.py for the full note):
//   * one thread block = one (batch*head, 64-row q tile); blocks run in any
//     order, the K/V walk is a loop inside the block;
//   * q (pre-scaled in f32), K and V tiles are staged in shared memory as
//     f32, rows padded to Dh+1 floats so the column-wise reads below hit
//     32 distinct banks;
//   * 4 threads own one q row: each computes 16 of the tile's 64 scores and
//     Dh/4 of the row's output columns; row max and row sum are combined
//     with two warp shuffles, the probabilities go through shared memory;
//   * both products are f32 FMAs, the same arithmetic as the TPU kernel,
//     which casts q/k/v to f32 before its dots.
//   * inputs are read through (b, h, s) strides with a unit Dh stride, so
//     the head split of a (B, S, H*Dh) projection is a view, not a copy.
//   * the ragged edge is masked here: any S >= 1 runs, rows past s_q are
//     computed on zeros and not stored, columns past s_k weigh exactly 0.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLanes = 4;  // threads per q row
constexpr int kThreads = kBlockQ * kLanes;
constexpr int kCols = kBlockK / kLanes;  // scores per thread per K tile
// Finite stand-in for -inf, as _MASK_VALUE in the TPU kernel.
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T, int kMaxDh>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  const int ld = dh + 1;
  float* qs = smem;                 // [kBlockQ][ld]
  float* ks = qs + kBlockQ * ld;    // [kBlockK][ld]
  float* vs = ks + kBlockK * ld;    // [kBlockK][ld]
  float* ps = vs + kBlockK * ld;    // [kBlockQ][kBlockK + 1]

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int qrow = q0 + row;

  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    qs[r * ld + d] =
        q0 + r < p.s_q ? to_f32(q[(q0 + r) * p.sq.s + d]) * p.scale : 0.f;
  }

  float m = kMaskValue;
  float l = 0.f;
  float acc[kMaxDh / kLanes];
#pragma unroll
  for (int i = 0; i < kMaxDh / kLanes; ++i) acc[i] = 0.f;

  int num_k = (p.s_k + kBlockK - 1) / kBlockK;
  if (p.causal) {
    // Only the K tiles that meet this q tile's causal triangle.
    num_k = min(num_k, (q0 + kBlockQ + kBlockK - 1) / kBlockK);
  }
  const float* qr = qs + row * ld;
  float* pr = ps + row * (kBlockK + 1);

  for (int t = 0; t < num_k; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's reads of ks/vs are done
    for (int i = tid; i < kBlockK * dh; i += kThreads) {
      const int r = i / dh, d = i % dh;
      const bool in = k0 + r < p.s_k;
      ks[r * ld + d] = in ? to_f32(k[(k0 + r) * p.sk.s + d]) : 0.f;
      vs[r * ld + d] = in ? to_f32(v[(k0 + r) * p.sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
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
    for (int i = 0; i < kMaxDh / kLanes; ++i) acc[i] *= alpha;
    const int live = min(kBlockK, p.s_k - k0);
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
    T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h + qrow * p.so.s;
#pragma unroll
    for (int i = 0; i < kMaxDh / kLanes; ++i) {
      const int d = lane + i * kLanes;
      if (d < dh) o[d] = from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int kMaxDh>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(3) * kBlockQ * (p.dh + 1) +
                       size_t(kBlockQ) * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kMaxDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.s_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, kMaxDh><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int batch_heads, cudaStream_t stream) {
  if (p.dh <= 32) return launch<T, 32>(p, batch_heads, stream);
  if (p.dh <= 64) return launch<T, 64>(p, batch_heads, stream);
  return launch<T, 128>(p, batch_heads, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// strides: 12 element strides, (b, h, s) for q, k, v and o in that order.
// Returns a cudaError_t value; 0 means the kernel was launched.
extern "C" int defer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int s_q, int s_k, int dh,
    const long long* strides, float scale, int causal, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 || s_q < 1 || s_k < 1 || batch < 1 ||
      heads < 1 || (causal && s_q != s_k) ||
      (long long)(s_q + kBlockQ - 1) / kBlockQ > 65535) {
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
    case 0: return int(launch_dh<float>(p, bh, st));
    case 1: return int(launch_dh<__half>(p, bh, st));
    case 2: return int(launch_dh<__nv_bfloat16>(p, bh, st));
    default: return int(cudaErrorInvalidValue);
  }
}
