// Paged flash decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel
// defer_tpu/ops/pallas_attention.py::paged_flash_decode (body
// _paged_decode_kernel, live range _decode_lo_hi): one query token per slot,
// q [B, Hq, Dh], against ONE layer of the paged KV pool, pool [NB, Hkv, bs,
// Dh], through the slot's block table [B, MB]: row r of slot b is row r % bs
// of pool block tables[b, r / bs]. The G = Hq/Hkv query rows of a KV head
// share its reads. Softmax over the live columns [max(pos-window+1, 0),
// min(pos, MB*bs-1)], q pre-scaled by Dh^-0.5 in f32, f32 m/l/acc with the
// same finite mask value, output acc / l cast to q's dtype.
//
// The pool is q's dtype, or int8 with one f32 scale per (block, KV head),
// scale_k/scale_v [NB, Hkv] (the TPU kernel's `quantized` path): a row's
// value is int8 payload x its block's scale.
//
// What bounds it on an H100: the bytes of the LIVE pool rows. The kernel
// reads pos[b] and the table from device memory (no host sync) and fetches
// only the rows of the live range, each from the pool block its table entry
// names; table entries past pos (trash block 0, or blocks the slot owns but
// has not reached) are never read, as the TPU kernel's clamped index maps
// guarantee.
//
// Design (defer_tpu_torch/csrc/flash_decode.cu's, plus the indirection):
//   * split-K over whole blocks: the grid is (splits, Hkv * qgroups, B),
//     fixed by the table span; each slot's live blocks are cut into `splits`
//     chunks of at least ceil(kMinChunk / bs) blocks, sized in the kernel
//     from pos; a CTA whose chunk lies past the live range exits at once;
//   * a chunk starts on a block edge, so its rows walk the pool block by
//     block; each row's address is tables[b, r / bs] * block stride +
//     (r % bs) * row stride, and a head's bs x Dh rows of one block are
//     contiguous in the pool;
//   * each CTA stages up to kG query rows of one KV head in registers (kG 4
//     when G <= 4, else 8); its 8 warps walk the chunk kRows rows at a time,
//     a lane holding Dh/32 columns of each row: one coalesced read of a K/V
//     row serves all G query rows. Scores are warp-shuffle sums; each warp
//     keeps its own online-softmax state in registers;
//   * the warps' states merge through shared memory; with one split the CTA
//     writes the output, otherwise (m, l, acc) go to an f32 workspace and a
//     second, small kernel merges the live splits of each (b, head);
//   * the products are f32 FMAs, as the TPU kernel casts to f32 before its
//     dots;
//   * an int8 pool is read as int8 (one byte an element: at Dh 128 a lane
//     loads its 4 columns of a row in one 4-byte load) and widened in
//     registers. The block scale is read once per row beside the table
//     entry, never for a row outside the live range, and is folded in
//     after the reduction, not per element: the score is
//     sk * sum(q . k_int8), and the row's softmax weight times sv
//     multiplies v_int8 in the accumulation. The scales of dead table
//     columns, like their payload, are never read.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
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
  float* part_acc;       // [B, Hq, splits, Dh]
  float* part_ml;        // [B, Hq, splits, 2]
  long long qb, qh;      // element strides; the Dh stride is 1
  long long kn, kh, ks;  // pool: block, head, row
  long long vn, vh, vs;
  long long tb;          // tables: slot
  long long ob, oh;
  long long skn, skh;    // scales: block, head
  long long svn, svh;
  int hq, group, bs, mb, window, splits, min_chunk_blocks;
  float scale;
};

// The live rows [lo, hi] of slot b, its first live block, and the blocks
// each split takes: the same arithmetic in both kernels, so they agree on
// which splits ran.
struct Live {
  int lo, hi, lo_blk, nblk, chunk;
};

__device__ __forceinline__ Live live_range(const Params& p, int b) {
  const int pb = p.pos[b * p.pos_stride];
  Live r;
  r.hi = min(pb, p.mb * p.bs - 1);
  r.lo = p.window > 0 ? max(pb - p.window + 1, 0) : 0;
  r.lo_blk = r.lo / p.bs;
  r.nblk = r.hi / p.bs - r.lo_blk + 1;
  r.chunk = max(p.min_chunk_blocks, (r.nblk + p.splits - 1) / p.splits);
  return r;
}

// T: q and o; P: the pool, T or int8_t (then scaled by p.sk / p.sv).
template <typename T, typename P, int kVec, int kG>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  constexpr int kDh = kVec * 32;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
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
  // This split's whole blocks, as rows, cut to the live range.
  const int blk0 = live.lo_blk + split * live.chunk;
  const int r0 = max(blk0 * p.bs, live.lo);
  const int r1 = min((blk0 + live.chunk) * p.bs, live.hi + 1);
  // Past the live range: nothing to read. Split 0 always reports, so a
  // slot always has one partial.
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
__global__ void __launch_bounds__(kDh) paged_decode_combine(Params p) {
  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int d = threadIdx.x;
  const Live live = live_range(p, b);
  const int active =
      max(1, min(p.splits, (live.nblk + live.chunk - 1) / live.chunk));
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

template <typename T, typename P, int kVec>
cudaError_t launch(const Params& p, int batch, int hkv, cudaStream_t stream) {
  const int tile = p.group <= 4 ? 4 : kMaxG;
  const dim3 grid(p.splits, hkv * ((p.group + tile - 1) / tile), batch);
  if (tile == 4) {
    paged_decode_kernel<T, P, kVec, 4><<<grid, kThreads, 0, stream>>>(p);
  } else {
    paged_decode_kernel<T, P, kVec, kMaxG><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  paged_decode_combine<T, kVec * 32>
      <<<batch * p.hq, kVec * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_dh(const Params& p, int dh, int batch, int hkv,
                      cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, P, 1>(p, batch, hkv, stream);
    case 64: return launch<T, P, 2>(p, batch, hkv, stream);
    case 128: return launch<T, P, 4>(p, batch, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The pool is q's type, or int8 with scales.
template <typename T>
cudaError_t launch_pool(const Params& p, bool int8_pool, int dh, int batch,
                        int hkv, cudaStream_t stream) {
  return int8_pool ? launch_dh<T, int8_t>(p, dh, batch, hkv, stream)
                   : launch_dh<T, T>(p, dh, batch, hkv, stream);
}

}  // namespace

// dtype (q and o): 0 = float32, 1 = float16, 2 = bfloat16; pool_dtype: the
// same code as dtype, or 3 = int8, which needs scale_k / scale_v, f32
// [NB, Hkv] on the device. tables: int32 [B, MB] on the device; pos: int32
// on the device, pos_stride 1 for one position per slot or 0 to broadcast
// one. strides: 15 element strides, (b, h) of q, (block, h, row) of pool_k,
// (block, h, row) of pool_v, b of tables, (b, h) of o, (block, h) of
// scale_k, (block, h) of scale_v (unused for a float pool). window <= 0
// means no window. part_acc / part_ml: f32 workspaces of B*Hq*splits*Dh
// and B*Hq*splits*2 floats (unused, may be null, when splits == 1).
// Returns a cudaError_t value; 0 means launched.
extern "C" int defer_paged_flash_decode(
    const void* q, const void* pool_k, const void* pool_v, void* o,
    const int* tables, const float* scale_k, const float* scale_v,
    const int* pos, long long pos_stride, float* part_acc, float* part_ml,
    int dtype, int pool_dtype, int batch, int hq, int hkv, int bs, int mb,
    int dh, const long long* strides, int window, int splits, float scale,
    void* stream) {
  const bool int8_pool = pool_dtype == 3;
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || bs < 1 || mb < 1 ||
      splits < 1 || batch > 65535 || hq > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (pool_dtype != dtype && !int8_pool) ||
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
  p.pos = pos;
  p.pos_stride = pos_stride;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
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
  p.mb = mb;
  p.window = window;
  p.splits = splits;
  p.min_chunk_blocks = (kMinChunk + bs - 1) / bs;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_pool<float>(p, int8_pool, dh, batch, hkv, st));
    case 1: return int(launch_pool<__half>(p, int8_pool, dh, batch, hkv, st));
    case 2:
      return int(
          launch_pool<__nv_bfloat16>(p, int8_pool, dh, batch, hkv, st));
    default: return int(cudaErrorInvalidValue);
  }
}
