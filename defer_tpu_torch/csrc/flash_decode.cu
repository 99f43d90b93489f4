// Flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel defer_tpu/ops/pallas_attention.py::flash_decode
// (body _decode_kernel, live range _decode_lo_hi): one query token per
// sequence against a contiguous KV cache, q [B, Hq, Dh] against k/v
// [B, Hkv, S, Dh], the G = Hq/Hkv query rows of a KV head sharing its K/V
// reads. Softmax over the live columns [max(pos-window+1, 0), min(pos, S-1)]
// of each sequence, scores times Dh^-0.5 in f32, f32 m/l/acc with the same
// finite mask value, output acc / l cast to q's dtype.
//
// What bounds it on an H100: the bytes of the LIVE K/V rows. The kernel
// reads pos[b] from device memory (no host sync) and loads only the rows of
// that live range, never the whole S of the cache. At 4 KB a live row
// (Mistral-7B, bf16) a 180-row tick moves under 3 MB, about 1 us at
// 3.35 TB/s, so what a call costs is latency: loads in flight, the launch,
// and the merge of the CTAs that share a sequence.
//
// Design for bf16 / f16 q: decode_tile.cuh's engine (one kernel a call: a
// cluster of up to 8 CTAs per (sequence, KV head, 16 query rows) takes equal
// shares of the live 64-row tiles, each warp stages its 16-row slices of K
// and V with cp.async in a 3-stage ring, the products run on mma.sync, and
// the CTAs' states merge through distributed shared memory). The grid is
// (C, Hkv * ceil(G / 16), B) in clusters of (C, 1, 1); C comes from the
// wrapper (_cluster_size, from S only), lowered until every cluster fits on
// the card at once. q, k and v rows start on 16 bytes. G > 16 takes
// ceil(G / 16) CTAs a KV head.
//
// f32 q keeps the f32 FMA loop (flash_decode_f32 below), chosen by dtype:
// the tensor cores take f32 only as TF32, which misses the f32 tolerance of
// 1e-5, and no card path runs f32. Each of its CTAs stages up to kG query
// rows of one KV head in registers (4 when G <= 4, else 8) and takes one
// chunk of at least kMinChunk live rows; its 8 warps walk the chunk kRows
// rows at a time, a lane holding Dh/32 columns of a row, with warp-shuffle
// score sums. The same cluster merge makes it one kernel a call too.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

using dtile::kMaskValue;

// K/V stages in a warp's ring on the tensor-core path.
constexpr int kStages = 3;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* pos;
  long long pos_stride;  // 0 broadcasts one position to the batch
  long long qb, qh;      // element strides; the Dh stride is 1
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh;
  int hq, group, seq, window;
  float scale;
  unsigned long long* runs;  // the card's count of this kernel's runs
};

// One thread of the grid adds one to the card's count of runs, so a launch
// replayed from a captured CUDA graph is counted where it runs.
__device__ __forceinline__ void count_run(const Params& p) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    atomicAdd(p.runs, 1ull);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(dtile::kThreads)
    flash_decode_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_run(p);
  const int qgroups = (p.group + dtile::kQRows - 1) / dtile::kQRows;
  const int kvh = blockIdx.y / qgroups;
  const int g0 = (blockIdx.y % qgroups) * dtile::kQRows;
  const int ng = min(dtile::kQRows, p.group - g0);
  const int b = blockIdx.z;
  const int hq0 = kvh * p.group + g0;  // first query head of this CTA
  dtile::Contig<T> src;
  src.k = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
  src.v = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;
  src.ks = p.ks;
  src.vs = p.vs;
  dtile::attend<T, T, kD, kStages>(
      src, static_cast<const T*>(p.q) + b * p.qb + hq0 * p.qh, p.qh, ng,
      p.pos + b * p.pos_stride, p.seq, p.window, p.scale,
      static_cast<T*>(p.o) + b * p.ob + hq0 * p.oh, p.oh, smem);
}

// -- f32 q: the FMA loop ------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;       // K/V rows a warp holds in flight
constexpr int kMinChunk = 32;  // fewest live rows a rank takes

template <int kVec>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float (&dst)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  } else if constexpr (kVec == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int kVec, int kG>
__global__ void __launch_bounds__(kThreads) flash_decode_f32(Params p) {
  constexpr int kDh = kVec * 32;
  count_run(p);
  __shared__ float sm_m[kWarps][kG];
  __shared__ float sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kDh];
  __shared__ dtile::Partial<kG, kDh> part;

  const int qgroups = (p.group + kG - 1) / kG;
  const int kvh = blockIdx.y / qgroups;
  const int g0 = (blockIdx.y % qgroups) * kG;
  const int ng = min(kG, p.group - g0);
  const int b = blockIdx.z;
  const dtile::Live live =
      dtile::live_range(p.pos + b * p.pos_stride, p.seq, p.window);
  // This rank's chunk of the live rows (none when the chunks end before it).
  const int n = live.hi - live.lo + 1;
  const int chunk = max(kMinChunk, (n + int(gridDim.x) - 1) / int(gridDim.x));
  const int r0 = live.lo + int(blockIdx.x) * chunk;
  const int r1 = min(r0 + chunk, live.hi + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq0 = kvh * p.group + g0;  // first query head of this CTA

  float qr[kG][kVec];
  {
    const float* q = static_cast<const float*>(p.q) + b * p.qb + hq0 * p.qh +
                     lane * kVec;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < ng) {
        load_vec<kVec>(q + g * p.qh, qr[g]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] *= p.scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] = 0.f;
      }
    }
  }
  const float* k = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh +
                   lane * kVec;
  const float* v = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh +
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
        load_vec<kVec>(k + (long long)(r + i) * p.ks, kr[i]);
        load_vec<kVec>(v + (long long)(r + i) * p.vs, vr[i]);
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

  // Merge the warps' states into the CTA's. A warp (or a whole rank) that
  // took no rows holds (mask, 0, 0) and weighs exp(mask - M) = 0.
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
    part.o[g][d] = asum;
    if (d == 0) {
      part.m[g] = mx;
      part.l[g] = lsum;
    }
  }
  dtile::cluster_merge<float, kG, kDh, false>(
      &part, ng, static_cast<float*>(p.o) + b * p.ob + hq0 * p.oh, p.oh,
      threadIdx.x, kThreads);
}

template <typename T, int kD>
cudaError_t launch(const Params& p, int batch, int hkv, int cluster,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kVec = kD / 32;
    if (p.group <= 4) {
      const dim3 grid(cluster, hkv * ((p.group + 3) / 4), batch);
      return dtile::launch_cluster(flash_decode_f32<kVec, 4>, p, grid,
                                   kThreads, 0, stream);
    }
    const dim3 grid(cluster, hkv * ((p.group + 7) / 8), batch);
    return dtile::launch_cluster(flash_decode_f32<kVec, 8>, p, grid,
                                 kThreads, 0, stream);
  } else {
    constexpr size_t smem = dtile::Layout<T, T, kD, kStages>::bytes;
    static bool ready = false;  // the attribute is set once a process
    if (!ready) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_decode_mma<T, kD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return err;
      ready = true;
    }
    const int qgroups = (p.group + dtile::kQRows - 1) / dtile::kQRows;
    static int known[dtile::kMaxCluster + 1] = {};
    const int c = dtile::fit_cluster(flash_decode_mma<T, kD>, cluster,
                                     batch * hkv * qgroups, dtile::kThreads,
                                     smem, known);
    const dim3 grid(c, hkv * qgroups, batch);
    return dtile::launch_cluster(flash_decode_mma<T, kD>, p, grid,
                                 dtile::kThreads, smem, stream);
  }
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, int batch, int hkv,
                      int cluster, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, batch, hkv, cluster, stream);
    case 64: return launch<T, 64>(p, batch, hkv, cluster, stream);
    case 128: return launch<T, 128>(p, batch, hkv, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. pos: int32 on the device,
// pos_stride 1 for one position per sequence or 0 to broadcast one.
// strides: 10 element strides, (b, h) of q, (b, h, s) of k, (b, h, s) of v,
// (b, h) of o. window <= 0 means no window. cluster: the CTAs that share a
// (sequence, KV head), 1 to 8. runs: a device uint64 the kernel adds one
// to each time it runs. Returns a cudaError_t value; 0 means launched.
extern "C" int defer_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    long long pos_stride, int dtype, int batch, int hq, int hkv, int seq,
    int dh, const long long* strides, int window, int cluster, float scale,
    void* stream, unsigned long long* runs) {
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || seq < 1 ||
      cluster < 1 || cluster > dtile::kMaxCluster || batch > 65535 ||
      hq > 65535) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.pos = pos;
  p.pos_stride = pos_stride;
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
  p.scale = scale;
  p.runs = runs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_dh<float>(p, dh, batch, hkv, cluster, st));
    case 1: return int(launch_dh<__half>(p, dh, batch, hkv, cluster, st));
    case 2:
      return int(launch_dh<__nv_bfloat16>(p, dh, batch, hkv, cluster, st));
    default: return int(cudaErrorInvalidValue);
  }
}
