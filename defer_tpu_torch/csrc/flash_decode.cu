// Flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel defer_tpu/ops/pallas_attention.py::flash_decode
// (body _decode_kernel, live range _decode_lo_hi): one query token per
// sequence against a contiguous KV cache, q [B, Hq, Dh] against k/v
// [B, Hkv, S, Dh], the G = Hq/Hkv query rows of a KV head sharing its K/V
// reads. Softmax over the live columns [max(pos-window+1, 0), min(pos, S-1)]
// of each sequence, q pre-scaled by Dh^-0.5 in f32, f32 m/l/acc with the
// same finite mask value, output acc / l cast to q's dtype.
//
// What bounds it on an H100: the bytes of the LIVE K/V rows. The kernel
// reads pos[b] from device memory (no host sync) and loads only the rows of
// that live range, never the whole S of the cache: at the serving path's
// depths (pos < 200 of S = 4096) a kernel that read the whole cache would
// move over 20x the bytes.
//
// Design (see defer_tpu_torch/ops/flash_decode.py for the note in full):
//   * split-K ("flash-decoding"): the grid is (splits, Hkv * qgroups, B);
//     the live range of each sequence is cut into `splits` chunks of at
//     least kMinChunk rows, sized in the kernel from pos, so short and long
//     sequences alike spread over many CTAs; a CTA whose chunk lies past the
//     live range exits at once;
//   * each CTA stages up to kG query rows of one KV head in registers (kG is
//     4 when G <= 4, else 8: registers, and so resident CTAs, follow G);
//     its 8 warps walk the chunk kRows rows at a time, a lane holding Dh/32
//     columns of each row: one coalesced read of each K/V row serves all G
//     query rows. Scores are warp-shuffle sums; each warp keeps its own
//     online-softmax state (m, l, acc) in registers;
//   * the 8 warps' states merge through shared memory; with one split the
//     CTA writes the output, otherwise (m, l, acc) go to an f32 workspace and
//     a second, small kernel merges the live splits of each (b, head);
//   * the products are f32 FMAs on the CUDA cores, as the TPU kernel casts
//     to f32 before its dots; at G <= 8 rows the tensor cores do not pay.
//   * q, k and v are read through (b, h[, s]) element strides with a unit Dh
//     stride; rows must be aligned to the width of one lane's vector load.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;       // most query rows per CTA
constexpr int kRows = 4;       // K/V rows a warp holds in flight
constexpr int kMinChunk = 32;  // fewest live rows a split takes (see .py)
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

template <int kBytes>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// kVec consecutive elements at src, widened to f32, in loads of up to
// 16 bytes.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float (&dst)[kVec]) {
  constexpr int kBytes = kVec * int(sizeof(T));
  constexpr int kChunk = kBytes > 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / int(sizeof(T));
#pragma unroll
  for (int c = 0; c < kVec / kPer; ++c) {
    using R = typename Raw<kChunk>::type;
    const R raw = *reinterpret_cast<const R*>(src + c * kPer);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[c * kPer + e] = to_f32(vals[e]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* pos;
  long long pos_stride;  // 0 broadcasts one position to the batch
  float* part_acc;       // [B, Hq, splits, Dh]
  float* part_ml;        // [B, Hq, splits, 2]
  long long qb, qh;      // element strides; the Dh stride is 1
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh;
  int hq, group, seq, window, splits;
  float scale;
};

// The live rows [lo, hi] of sequence b, and the rows each split takes:
// the same arithmetic in both kernels, so they agree on which splits ran.
struct Live {
  int lo, hi, chunk;
};

__device__ __forceinline__ Live live_range(const Params& p, int b) {
  const int pb = p.pos[b * p.pos_stride];
  Live r;
  r.hi = min(pb, p.seq - 1);
  r.lo = p.window > 0 ? max(pb - p.window + 1, 0) : 0;
  const int n = r.hi - r.lo + 1;
  r.chunk = max(kMinChunk, (n + p.splits - 1) / p.splits);
  return r;
}

template <typename T, int kVec, int kG>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Params p) {
  constexpr int kDh = kVec * 32;
  __shared__ float sm_m[kWarps][kG];
  __shared__ float sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kDh];

  const int split = blockIdx.x;
  const int qgroups = (p.group + kG - 1) / kG;
  const int kvh = blockIdx.y / qgroups;
  const int g0 = (blockIdx.y % qgroups) * kG;
  const int ng = min(kG, p.group - g0);
  const int b = blockIdx.z;
  const Live live = live_range(p, b);
  const int r0 = live.lo + split * live.chunk;
  const int r1 = min(r0 + live.chunk, live.hi + 1);
  // Past the live range: nothing to read. Split 0 always reports, so a
  // sequence always has one partial (an empty one when pos < 0).
  if (r0 >= r1 && split > 0) return;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq0 = kvh * p.group + g0;  // first query head of this CTA

  float qr[kG][kVec];
  {
    const T* q = static_cast<const T*>(p.q) + b * p.qb + hq0 * p.qh +
                 lane * kVec;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < ng) {
        load_vec<T, kVec>(q + g * p.qh, qr[g]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] *= p.scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] = 0.f;
      }
    }
  }
  const T* k = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh +
               lane * kVec;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh +
               lane * kVec;

  float m[kG], l[kG], acc[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  for (int r = r0 + warp * kRows; r < r1; r += kWarps * kRows) {
    float kr[kRows][kVec], vr[kRows][kVec];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r + i < r1) {
        load_vec<T, kVec>(k + (long long)(r + i) * p.ks, kr[i]);
        load_vec<T, kVec>(v + (long long)(r + i) * p.vs, vr[i]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kr[i][e] = vr[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < ng) {  // uniform across the CTA
        float s[kRows];
        float m_new = m[g];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) d = fmaf(qr[g][e], kr[i][e], d);
          d = warp_sum(d);
          s[i] = r + i < r1 ? d : -INFINITY;  // past the chunk: weight 0
          m_new = fmaxf(m_new, s[i]);
        }
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i] = expf(s[i] - m_new);
          psum += s[i];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int i = 0; i < kRows; ++i) a = fmaf(s[i], vr[i][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

  // Merge the warps' states. A warp that took no rows holds (mask, 0, 0)
  // and weighs exp(mask - M) = 0.
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[warp][g][lane * kVec + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * kDh; idx += kThreads) {
    const int g = idx / kDh;
    const int d = idx % kDh;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += c * sm_l[w][g];
      asum += c * sm_acc[w][g][d];
    }
    const int h = hq0 + g;
    if (p.splits == 1) {
      T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
      o[d] = from_f32<T>(asum / lsum);
    } else {
      const long long slot =
          ((long long)b * p.hq + h) * p.splits + split;
      p.part_acc[slot * kDh + d] = asum;
      if (d == 0) {
        p.part_ml[slot * 2] = mx;
        p.part_ml[slot * 2 + 1] = lsum;
      }
    }
  }
}

// One CTA per (b, query head), one thread per column: merges the partials
// of the splits that ran.
template <typename T, int kDh>
__global__ void __launch_bounds__(kDh) flash_decode_combine(Params p) {
  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int d = threadIdx.x;
  const Live live = live_range(p, b);
  const int n = live.hi - live.lo + 1;
  const int active = max(1, min(p.splits, (n + live.chunk - 1) / live.chunk));
  const long long base = ((long long)b * p.hq + h) * p.splits;
  const float* ml = p.part_ml + base * 2;
  const float* acc = p.part_acc + base * kDh;
  float mx = kMaskValue;
  for (int j = 0; j < active; ++j) mx = fmaxf(mx, ml[2 * j]);
  float lsum = 0.f, asum = 0.f;
  for (int j = 0; j < active; ++j) {
    const float c = expf(ml[2 * j] - mx);
    lsum += c * ml[2 * j + 1];
    asum += c * acc[j * kDh + d];
  }
  T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
  o[d] = from_f32<T>(asum / lsum);
}

template <typename T, int kVec>
cudaError_t launch(const Params& p, int batch, int hkv, cudaStream_t stream) {
  const int tile = p.group <= 4 ? 4 : kMaxG;
  const dim3 grid(p.splits, hkv * ((p.group + tile - 1) / tile), batch);
  if (tile == 4) {
    flash_decode_kernel<T, kVec, 4><<<grid, kThreads, 0, stream>>>(p);
  } else {
    flash_decode_kernel<T, kVec, kMaxG><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  flash_decode_combine<T, kVec * 32><<<batch * p.hq, kVec * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, int batch, int hkv,
                      cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 1>(p, batch, hkv, stream);
    case 64: return launch<T, 2>(p, batch, hkv, stream);
    case 128: return launch<T, 4>(p, batch, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. pos: int32 on the device,
// pos_stride 1 for one position per sequence or 0 to broadcast one.
// strides: 10 element strides, (b, h) of q, (b, h, s) of k, (b, h, s) of v,
// (b, h) of o. window <= 0 means no window. part_acc / part_ml: f32
// workspaces of B*Hq*splits*Dh and B*Hq*splits*2 floats (unused, may be
// null, when splits == 1). Returns a cudaError_t value; 0 means launched.
extern "C" int defer_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    long long pos_stride, float* part_acc, float* part_ml, int dtype,
    int batch, int hq, int hkv, int seq, int dh, const long long* strides,
    int window, int splits, float scale, void* stream) {
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || seq < 1 ||
      splits < 1 || batch > 65535 ||
      hq > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.pos = pos;
  p.pos_stride = pos_stride;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.qb = strides[0];
  p.qh = strides[1];
  p.kb = strides[2];
  p.kh = strides[3];
  p.ks = strides[4];
  p.vb = strides[5];
  p.vh = strides[6];
  p.vs = strides[7];
  p.ob = strides[8];
  p.oh = strides[9];
  p.hq = hq;
  p.group = hq / hkv;
  p.seq = seq;
  p.window = window;
  p.splits = splits;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_dh<float>(p, dh, batch, hkv, st));
    case 1: return int(launch_dh<__half>(p, dh, batch, hkv, st));
    case 2: return int(launch_dh<__nv_bfloat16>(p, dh, batch, hkv, st));
    default: return int(cudaErrorInvalidValue);
  }
}
