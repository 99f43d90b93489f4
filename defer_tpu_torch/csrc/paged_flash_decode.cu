// Paged flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel
// defer_tpu/ops/pallas_attention.py::paged_flash_decode (body
// _paged_decode_kernel, live range _decode_lo_hi): one query token per slot,
// q [B, Hq, Dh], against ONE layer of the paged KV pool, pool [NB, Hkv, bs,
// Dh], through the slot's block table [B, MB]: row r of slot b is row r % bs
// of pool block tables[b, r / bs]. The G = Hq/Hkv query rows of a KV head
// share its reads. Softmax over the live columns [max(pos-window+1, 0),
// min(pos, MB*bs-1)], scores times Dh^-0.5 in f32, f32 m/l/acc with the same
// finite mask value, output acc / l cast to q's dtype.
//
// The pool is q's dtype, or int8 with one f32 scale per (block, KV head),
// scale_k/scale_v [NB, Hkv] (the TPU kernel's `quantized` path): a row's
// value is int8 payload x its block's scale.
//
// What bounds it on an H100: the bytes of the LIVE pool rows (4 KB a row in
// bf16 at Mistral-7B's shape, 2 KB in int8), and at the serving path's
// depths the latency of a call. The kernel reads pos[b] and the table on the
// card (no host sync) and fetches only the rows of the live range, each from
// the pool block its table entry names; table entries outside the live
// range (trash block 0, or blocks the slot owns but has not reached), and
// their scales, are never read, as the TPU kernel's clamped index maps
// guarantee.
//
// Design for bf16 / f16 q: decode_tile.cuh's engine with the table policy
// (dtile::Paged): one kernel a call, a cluster of up to 8 CTAs per (slot,
// KV head, 16 query rows) taking equal shares of the live 64-row tiles, each
// warp staging its 16-row slices by cp.async in a ring (3 stages on a float
// pool; 5 on an int8 pool, whose slices are half the bytes), each slice's
// table entries copied kStages - 1 slices ahead of the copies that need
// them (with the row's place in its block, the one division by bs a row
// takes, worked out then), an int8 pool's scales copied once a block and
// folded per column into S and P, mma.sync products, and the CTAs' states
// merged through distributed shared memory. The grid is (C, Hkv * ceil(G /
// 16), B) in clusters of (C, 1, 1); C comes from the wrapper
// (_cluster_size, from the table span only), lowered until every cluster
// fits on the card at once. An int8 pool is copied as int8 and widened in
// registers, exactly, into f16 mma operands.
//
// f32 q keeps the f32 FMA loop (paged_decode_f32 below, any pool), chosen by
// dtype: the tensor cores take f32 only as TF32, which misses the f32
// tolerance of 1e-5, and no card path runs f32. Each rank of its cluster
// takes a chunk of whole blocks (at least kMinChunk rows); its 8 warps walk
// the chunk kRows rows at a time, a lane holding Dh/32 columns of a row,
// each row's block scale folded after the warp-shuffle score sum.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

using dtile::kMaskValue;

struct Params {
  const void* q;
  const void* k;  // pool [NB, Hkv, bs, Dh] of one layer
  const void* v;
  void* o;
  const int* tables;     // [B, MB]
  const float* sk;       // int8 pool: scales [NB, Hkv]; null otherwise
  const float* sv;
  const int* pos;
  long long pos_stride;  // 0 broadcasts one position to the batch
  long long qb, qh;      // element strides; the Dh stride is 1
  long long kn, kh, ks;  // pool: block, head, row
  long long vn, vh, vs;
  long long tb;          // tables: slot
  long long ob, oh;
  long long skn, skh;    // scales: block, head
  long long svn, svh;
  int hq, group, bs, mb, window;
  float scale;
  dtile::FastDiv bs_div;  // division by bs, set up on the host
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

// Ring stages of the tensor-core path: an int8 slice is half the bytes, so
// 5 stages keep as many bytes in flight as 3 of a bf16 pool, in the same
// shared memory (2 CTAs an SM either way).
template <typename P>
constexpr int kStagesOf = std::is_same<P, int8_t>::value ? 5 : 3;

// T: q and o (half or bf16); P: the pool, T or int8_t.
template <typename T, typename P, int kD>
__global__ void __launch_bounds__(dtile::kThreads)
    paged_decode_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_run(p);
  const int qgroups = (p.group + dtile::kQRows - 1) / dtile::kQRows;
  const int kvh = blockIdx.y / qgroups;
  const int g0 = (blockIdx.y % qgroups) * dtile::kQRows;
  const int ng = min(dtile::kQRows, p.group - g0);
  const int b = blockIdx.z;
  const int hq0 = kvh * p.group + g0;  // first query head of this CTA
  dtile::Paged<P> src;
  src.k = static_cast<const P*>(p.k) + kvh * p.kh;
  src.v = static_cast<const P*>(p.v) + kvh * p.vh;
  src.table = p.tables + b * p.tb;
  src.sk = p.sk + kvh * p.skh;
  src.sv = p.sv + kvh * p.svh;
  src.kn = p.kn;
  src.ks = p.ks;
  src.vn = p.vn;
  src.vs = p.vs;
  src.skn = p.skn;
  src.svn = p.svn;
  src.bs = p.bs_div;
  dtile::attend<T, P, kD, kStagesOf<P>>(
      src, static_cast<const T*>(p.q) + b * p.qb + hq0 * p.qh, p.qh, ng,
      p.pos + b * p.pos_stride, p.mb * p.bs, p.window, p.scale,
      static_cast<T*>(p.o) + b * p.ob + hq0 * p.oh, p.oh, smem);
}

// -- f32 q: the FMA loop ------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;       // K/V rows a warp holds in flight
constexpr int kMinChunk = 32;  // fewest live rows a rank takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

template <int kBytes>
struct Raw;
template <>
struct Raw<1> {
  using type = unsigned char;
};
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

// P: the pool, float or int8_t (then scaled by p.sk / p.sv).
template <typename P, int kVec, int kG>
__global__ void __launch_bounds__(kThreads) paged_decode_f32(Params p) {
  constexpr int kDh = kVec * 32;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  __shared__ float sm_m[kWarps][kG];
  __shared__ float sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kDh];
  __shared__ dtile::Partial<kG, kDh> part;

  count_run(p);

  const int qgroups = (p.group + kG - 1) / kG;
  const int kvh = blockIdx.y / qgroups;
  const int g0 = (blockIdx.y % qgroups) * kG;
  const int ng = min(kG, p.group - g0);
  const int b = blockIdx.z;
  const dtile::Live live =
      dtile::live_range(p.pos + b * p.pos_stride, p.mb * p.bs, p.window);
  // This rank's whole blocks, as rows, cut to the live range (none when
  // the chunks end before it).
  const int lo_blk = live.lo / p.bs;
  const int nblk = live.hi / p.bs - lo_blk + 1;
  const int chunk = max((kMinChunk + p.bs - 1) / p.bs,
                        (nblk + int(gridDim.x) - 1) / int(gridDim.x));
  const int blk0 = lo_blk + int(blockIdx.x) * chunk;
  const int r0 = max(blk0 * p.bs, live.lo);
  const int r1 = min((blk0 + chunk) * p.bs, live.hi + 1);

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
        load_vec<float, kVec>(q + g * p.qh, qr[g]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] *= p.scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][e] = 0.f;
      }
    }
  }
  const int* table = p.tables + b * p.tb;
  const P* k = static_cast<const P*>(p.k) + kvh * p.kh + lane * kVec;
  const P* v = static_cast<const P*>(p.v) + kvh * p.vh + lane * kVec;

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
    float ksc[kRows], vsc[kRows];  // the rows' block scales (int8 pool)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rr = r + i;
      ksc[i] = vsc[i] = 0.f;
      if (rr < r1) {
        // The pool block of this row, through the slot's table.
        const int col = rr / p.bs;
        const long long blk = __ldg(table + col);
        const long long row = rr - col * p.bs;
        load_vec<P, kVec>(k + blk * p.kn + row * p.ks, kr[i]);
        load_vec<P, kVec>(v + blk * p.vn + row * p.vs, vr[i]);
        if constexpr (kQuant) {
          ksc[i] = __ldg(p.sk + blk * p.skn + kvh * p.skh);
          vsc[i] = __ldg(p.sv + blk * p.svn + kvh * p.svh);
        }
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
          if constexpr (kQuant) d *= ksc[i];
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
        if constexpr (kQuant) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) s[i] *= vsc[i];
        }
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

template <typename T, typename P, int kD>
cudaError_t launch(const Params& p, int batch, int hkv, int cluster,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kVec = kD / 32;
    if (p.group <= 4) {
      const dim3 grid(cluster, hkv * ((p.group + 3) / 4), batch);
      return dtile::launch_cluster(paged_decode_f32<P, kVec, 4>, p, grid,
                                   kThreads, 0, stream);
    }
    const dim3 grid(cluster, hkv * ((p.group + 7) / 8), batch);
    return dtile::launch_cluster(paged_decode_f32<P, kVec, 8>, p, grid,
                                 kThreads, 0, stream);
  } else {
    constexpr size_t smem = dtile::Layout<T, P, kD, kStagesOf<P>>::bytes;
    static bool ready = false;  // the attribute is set once a process
    if (!ready) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_decode_mma<T, P, kD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return err;
      ready = true;
    }
    const int qgroups = (p.group + dtile::kQRows - 1) / dtile::kQRows;
    static int known[dtile::kMaxCluster + 1] = {};
    const int c = dtile::fit_cluster(paged_decode_mma<T, P, kD>, cluster,
                                     batch * hkv * qgroups, dtile::kThreads,
                                     smem, known);
    const dim3 grid(c, hkv * qgroups, batch);
    return dtile::launch_cluster(paged_decode_mma<T, P, kD>, p, grid,
                                 dtile::kThreads, smem, stream);
  }
}

template <typename T, typename P>
cudaError_t launch_dh(const Params& p, int dh, int batch, int hkv,
                      int cluster, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, P, 32>(p, batch, hkv, cluster, stream);
    case 64: return launch<T, P, 64>(p, batch, hkv, cluster, stream);
    case 128: return launch<T, P, 128>(p, batch, hkv, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The pool is q's type, or int8 with scales.
template <typename T>
cudaError_t launch_pool(const Params& p, bool int8_pool, int dh, int batch,
                        int hkv, int cluster, cudaStream_t stream) {
  return int8_pool
             ? launch_dh<T, int8_t>(p, dh, batch, hkv, cluster, stream)
             : launch_dh<T, T>(p, dh, batch, hkv, cluster, stream);
}

}  // namespace

// dtype (q and o): 0 = float32, 1 = float16, 2 = bfloat16; pool_dtype: the
// same code as dtype, or 3 = int8, which needs scale_k / scale_v, f32
// [NB, Hkv] on the device. tables: int32 [B, MB] on the device; pos: int32
// on the device, pos_stride 1 for one position per slot or 0 to broadcast
// one. strides: 15 element strides, (b, h) of q, (block, h, row) of pool_k,
// (block, h, row) of pool_v, b of tables, (b, h) of o, (block, h) of
// scale_k, (block, h) of scale_v (unused for a float pool). window <= 0
// means no window. cluster: the CTAs that share a (slot, KV head), 1 to 8.
// Returns a cudaError_t value; 0 means launched.
extern "C" int defer_paged_flash_decode(
    const void* q, const void* pool_k, const void* pool_v, void* o,
    const int* tables, const float* scale_k, const float* scale_v,
    const int* pos, long long pos_stride, int dtype, int pool_dtype,
    int batch, int hq, int hkv, int bs, int mb, int dh,
    const long long* strides, int window, int cluster, float scale,
    void* stream, unsigned long long* runs) {
  const bool int8_pool = pool_dtype == 3;
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || bs < 1 || mb < 1 ||
      bs >= (1 << 16) || (long long)mb * bs >= (1 << 24) ||
      cluster < 1 || cluster > dtile::kMaxCluster || batch > 65535 ||
      hq > 65535 || (pool_dtype != dtype && !int8_pool) ||
      (int8_pool && (scale_k == nullptr || scale_v == nullptr)) ||
      runs == nullptr) {
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
  p.pos = pos;
  p.pos_stride = pos_stride;
  p.qb = strides[0];
  p.qh = strides[1];
  p.kn = strides[2];
  p.kh = strides[3];
  p.ks = strides[4];
  p.vn = strides[5];
  p.vh = strides[6];
  p.vs = strides[7];
  p.tb = strides[8];
  p.ob = strides[9];
  p.oh = strides[10];
  p.skn = strides[11];
  p.skh = strides[12];
  p.svn = strides[13];
  p.svh = strides[14];
  p.hq = hq;
  p.group = hq / hkv;
  p.bs = bs;
  p.bs_div = dtile::FastDiv(bs);
  p.mb = mb;
  p.window = window;
  p.scale = scale;
  p.runs = runs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_pool<float>(p, int8_pool, dh, batch, hkv, cluster,
                                    st));
    case 1:
      return int(launch_pool<__half>(p, int8_pool, dh, batch, hkv, cluster,
                                     st));
    case 2:
      return int(launch_pool<__nv_bfloat16>(p, int8_pool, dh, batch, hkv,
                                            cluster, st));
    default: return int(cudaErrorInvalidValue);
  }
}
