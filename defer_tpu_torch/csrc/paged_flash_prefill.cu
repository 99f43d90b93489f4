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
// (and > start + r / G - window with a window). Scores times Dh^-0.5 in
// f32, f32 m/l/acc per row with the same finite mask value, output acc / l
// cast to q's dtype. The pool is q's dtype, or int8 with one f32 scale per
// (block, KV head), scale_k/scale_v [NB, Hkv] (the TPU kernel's `quantized`
// path).
//
// What bounds it on an H100: the live pool rows and q/o, each moved once
// (a few MB at a 2k-deep chunk, about 3 us), against 4 * T * Hq * Dh FLOP a
// live column (2.1 GFLOP at a 2k-deep 64-token chunk of Mistral-7B, 2 us on
// the tensor cores, 30x that on f32 FMAs). Both are small next to a
// single-CTA walk of 2k columns, so the design spreads the walk over the
// card and puts the products on the tensor cores.
//
// Design for bf16 / f16 q (attn_tile.cuh has the tile engine):
//   * one CTA = one (64-row tile of the T*G token-major query rows, KV head,
//     slot, split), 4 warps of 16 rows; S = Q K^T and O += P V on mma.sync
//     m16n8k16 with f32 accumulation, P rounded to q's type in registers;
//   * the CTA reads start[b] on the card and walks only the live columns of
//     its rows: from the edge of the block that holds the first row's window
//     start through the last row's position, in 64-column tiles;
//   * split-K over the live columns: the grid is (splits, row tiles * Hkv,
//     B), `splits` fixed by the wrapper from the SM count and the table span
//     (never from start); each (row tile, KV head, slot) cuts its live tiles
//     into `splits` chunks of whole tiles, sized here from start; a CTA whose
//     chunk lies past the live range exits at once. With one split the CTA
//     writes o; otherwise (m, l, acc) go to an f32 workspace and
//     paged_prefill_merge combines the splits that ran. live_span() is the
//     one piece of arithmetic both kernels use, so they agree on that count;
//   * each tile's K/V rows are resolved through the table by the threads
//     that copy them and staged with cp.async (16 bytes a copy),
//     double-buffered: tile t + 1 is in flight while tile t computes;
//   * only tiles that meet the causal edge, the window's edge or the end of
//     the live range are masked; the rest take no per-element test;
//   * rows padded past T * G compute on zeros and are never written;
//   * an int8 pool is copied as int8 (16 columns a copy), widened once per
//     CTA to q's type in shared memory (exact: |x| <= 127; one widening a
//     CTA, not one a warp, since each warp reads the whole tile), and its
//     scales are folded per column, not per element: S[:, c] times
//     scale_k[block(c)], P[:, c] times scale_v[block(c)] before P V. Columns
//     past the live range read neither payload nor scale.
//
// f32 q keeps the f32 FMA loop (paged_prefill_f32 below, one split, any
// pool), chosen by dtype in defer_paged_flash_prefill: the tensor cores
// take f32 only as TF32, which misses the f32 tolerance of 1e-5, and no
// card path runs f32. Its layout: 32 rows a CTA, 4 threads a row, K/V tiles
// widened to f32 in shared memory times a per-row block scale.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace {

using tile::kCols;
using tile::kMaskValue;
using tile::kRows;
using tile::kThreads;

struct Params {
  const void* q;
  const void* k;  // pool [NB, Hkv, bs, Dh] of one layer
  const void* v;
  void* o;
  const int* tables;  // [B, MB]
  const float* sk;    // int8 pool: scales [NB, Hkv]; null otherwise
  const float* sv;
  const int* start;
  float* part_acc;         // [B, Hkv, splits, row tiles * 64, Dh]
  float* part_ml;          // [B, Hkv, splits, row tiles * 64, 2]
  long long start_stride;  // 0 broadcasts one start to the batch
  long long qb, qh, qt;    // element strides; the Dh stride is 1
  long long kn, kh, ks;    // pool: block, head, row
  long long vn, vh, vs;
  long long tb;            // tables: slot
  long long ob, oh, ot;
  long long skn, skh;      // scales: block, head
  long long svn, svh;
  int hkv, group, t_q, bs, mb, dh, window, splits;
  float scale;
  unsigned long long* runs;  // the card's count of this kernel's runs
  unsigned long long* merge_runs;  // and of its split-K merge's
};

// One thread of the grid adds one to the card's count of runs, so a launch
// replayed from a captured CUDA graph is counted where it runs. The split-K
// merge that follows a split launch counts its own runs apart (merge_runs):
// a call is one run of the main kernel, plus one merge when it split.
__device__ __forceinline__ void count_run(unsigned long long* runs) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    atomicAdd(runs, 1ull);
  }
}

// The live columns [c0, hi] of the token-major rows r0 .. r0 + 63 of slot b,
// how many 64-column tiles they span from c0, and how many tiles a split
// takes. Kernel and merge both use it, so they agree on which splits ran
// (_split_columns in ops/paged_flash_prefill.py is the same arithmetic).
struct Span {
  int start, t_first, t_last, c0, hi, ntiles, chunk;
  __device__ __forceinline__ int active() const {
    return (ntiles + chunk - 1) / chunk;
  }
};

__device__ __forceinline__ Span live_span(const Params& p, int b, int r0) {
  Span s;
  s.start = p.start[b * p.start_stride];
  s.t_first = r0 / p.group;
  s.t_last = min((r0 + kRows - 1) / p.group, p.t_q - 1);
  s.hi = min(s.start + s.t_last, p.mb * p.bs - 1);
  const int lo =
      p.window > 0 ? max(s.start + s.t_first - p.window + 1, 0) : 0;
  s.c0 = lo / p.bs * p.bs;
  s.ntiles = max(1, (s.hi - s.c0) / kCols + 1);
  s.chunk = (s.ntiles + p.splits - 1) / p.splits;
  return s;
}

// 16 int8 values -> 16 values of T, exactly: a byte b becomes the f32
// 2^23 + (b ^ 0x80), less 2^23 + 128.
template <typename T>
__device__ __forceinline__ void widen16(uint4 w, uint4 (&out)[2]) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t res[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = in[j] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) -
             8388736.f;
    }
    res[2 * j] = tile::pack<T>(f[0], f[1]);
    res[2 * j + 1] = tile::pack<T>(f[2], f[3]);
  }
  out[0] = make_uint4(res[0], res[1], res[2], res[3]);
  out[1] = make_uint4(res[4], res[5], res[6], res[7]);
}

// T: q and o (half or bf16); P: the pool, T or int8_t (then scaled by
// p.sk / p.sv).
template <typename T, typename P, int kD>
__global__ void __launch_bounds__(kThreads) paged_prefill_mma(Params p) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  using Rows = tile::Rows<T, kD>;
  constexpr int ld = Rows::ld;                      // T row in shared memory
  constexpr int kPer = 16 / int(sizeof(P));          // pool elements a copy
  constexpr int kChunks = kD / kPer;                 // copies a pool row
  constexpr int ldp = kD + 16 / int(sizeof(P));      // pool row, staged
  constexpr int kTileT = kCols * ld;
  constexpr int kTileP = kCols * ldp;

  extern __shared__ __align__(16) unsigned char smem[];
  count_run(p.runs);
  T* qs = reinterpret_cast<T*>(smem);               // [kRows][ld]
  P* kst = reinterpret_cast<P*>(qs + kRows * ld);   // [2][kCols][ldp]
  P* vst = kst + 2 * kTileP;                        // [2][kCols][ldp]
  // int8 pool: the widened tile, and each column's multipliers.
  T* kw = reinterpret_cast<T*>(vst + 2 * kTileP);   // [kCols][ld]
  T* vw = kw + kTileT;                              // [kCols][ld]
  float* kmul = reinterpret_cast<float*>(vw + kTileT);  // [2][kCols]
  float* vmul = kmul + 2 * kCols;                       // [2][kCols]

  const int split = blockIdx.x;
  const int row_tiles = gridDim.y / p.hkv;
  const int kvh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kRows;  // first token-major row
  const int b = blockIdx.z;
  const Span sp = live_span(p, b, r0);
  const int tile0 = split * sp.chunk;
  // Past the live range: nothing to read. Split 0 always has a tile.
  if (tile0 >= sp.ntiles && split > 0) return;
  const int n_tiles = min(sp.chunk, sp.ntiles - tile0);

  const int rows = p.t_q * p.group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float scale = p.scale * tile::kLog2e;
  const int* table = p.tables + b * p.tb;
  const P* k = static_cast<const P*>(p.k) + kvh * p.kh;
  const P* v = static_cast<const P*>(p.v) + kvh * p.vh;

  // The query rows, gathered token-major.
  {
    const T* q = static_cast<const T*>(p.q) + b * p.qb;
    constexpr int kQChunks = kD / 8;
#pragma unroll
    for (int i = tid; i < kRows * kQChunks; i += kThreads) {
      const int r = i / kQChunks;
      const int c = (i % kQChunks) * 8;
      const int rr = r0 + r;
      const bool in = rr < rows;
      const T* src = in ? q + (kvh * p.group + rr % p.group) * p.qh +
                              (long long)(rr / p.group) * p.qt + c
                        : q;
      tile::cp_async16(qs + r * ld + c, src, in ? 16 : 0);
    }
  }

  // Each thread copies one 16-byte column chunk of kRowsPer rows of a
  // tile. lookup() starts the loads of those rows' table entries a tile
  // ahead of copy_tile(), so no copy waits on the table; copy_tile()
  // starts the copies and, for an int8 pool, the loads of the rows' block
  // scales, which store_scales() puts in shared memory after the tile
  // before has been computed.
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kRowsPer = kCols / kRowStep;
  static_assert(kThreads % kChunks == 0 && kCols % kRowStep == 0,
                "a thread copies one column chunk of whole rows");
  const int my_r = tid / kChunks;
  const int my_c = (tid % kChunks) * kPer;
  int blk[kRowsPer];  // pool block of each row, -1 past the live range
  float ksc[kRowsPer], vsc[kRowsPer];  // int8 pool: the rows' multipliers

  auto lookup = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) {
      const int col = k0 + my_r + u * kRowStep;
      blk[u] = col <= sp.hi ? __ldg(table + col / p.bs) : -1;
    }
  };
  auto copy_tile = [&](int k0, int buf) {
    P* kd = kst + buf * kTileP + my_c;
    P* vd = vst + buf * kTileP + my_c;
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) {
      const int r = my_r + u * kRowStep;
      const P* ksrc = k;
      const P* vsrc = v;
      if (blk[u] >= 0) {
        const long long row = (k0 + r) % p.bs;
        ksrc = k + blk[u] * p.kn + row * p.ks + my_c;
        vsrc = v + blk[u] * p.vn + row * p.vs + my_c;
      }
      tile::cp_async16(kd + r * ldp, ksrc, blk[u] >= 0 ? 16 : 0);
      tile::cp_async16(vd + r * ldp, vsrc, blk[u] >= 0 ? 16 : 0);
      if constexpr (kQuant) {
        if (my_c == 0) {
          ksc[u] = blk[u] >= 0
                       ? __ldg(p.sk + blk[u] * p.skn + kvh * p.skh) * scale
                       : 0.f;
          vsc[u] = blk[u] >= 0 ? __ldg(p.sv + blk[u] * p.svn + kvh * p.svh)
                               : 0.f;
        }
      }
    }
  };
  auto store_scales = [&](int buf) {
    if constexpr (kQuant) {
      if (my_c == 0) {
#pragma unroll
        for (int u = 0; u < kRowsPer; ++u) {
          kmul[buf * kCols + my_r + u * kRowStep] = ksc[u];
          vmul[buf * kCols + my_r + u * kRowStep] = vsc[u];
        }
      }
    }
  };

  const int first_col = sp.c0 + tile0 * kCols;
  lookup(first_col);
  copy_tile(first_col, 0);
  tile::cp_async_commit();
  store_scales(0);  // seen after the first __syncthreads
  if (n_tiles > 1) lookup(first_col + kCols);

  Rows acc;
  acc.init();
  // This thread's two rows (accumulator rows g and g + 8) and positions.
  const int row0 = r0 + 16 * warp + lane / 4;
  const int qpos[2] = {sp.start + row0 / p.group,
                       sp.start + (row0 + 8) / p.group};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = first_col + t * kCols;
    const int buf = t % 2;
    if (t + 1 < n_tiles) copy_tile(k0 + kCols, (t + 1) % 2);
    tile::cp_async_commit();  // possibly empty: keeps the group count even
    if (t + 2 < n_tiles) lookup(k0 + 2 * kCols);
    tile::cp_async_wait<1>();  // tile t (and q) have landed
    __syncthreads();
    const T* ktile;
    const T* vtile;
    if constexpr (kQuant) {
      constexpr int kW = kD / 16;  // 16-byte int8 chunks a row
      for (int i = tid; i < 2 * kCols * kW; i += kThreads) {
        const int which = i / (kCols * kW);
        const int r = (i % (kCols * kW)) / kW;
        const int c = (i % kW) * 16;
        const P* src = (which ? vst : kst) + buf * kTileP + r * ldp + c;
        T* dst = (which ? vw : kw) + r * ld + c;
        uint4 out[2];
        widen16<T>(*reinterpret_cast<const uint4*>(src), out);
        reinterpret_cast<uint4*>(dst)[0] = out[0];
        reinterpret_cast<uint4*>(dst)[1] = out[1];
      }
      __syncthreads();
      ktile = kw;
      vtile = vw;
    } else {
      ktile = kst + buf * kTileP;
      vtile = vst + buf * kTileP;
    }
    if (t == 0) acc.load_q(qs, warp, lane, kD / 16);

    float s[kCols / 8][4];
    acc.scores(ktile, lane, kD / 16, s);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * (lane % 4) + (e % 2);
        s[n][e] *= kQuant ? kmul[buf * kCols + c] : scale;
      }
    }
    const bool edge = k0 + kCols - 1 > sp.hi ||
                      k0 + kCols - 1 > sp.start + sp.t_first ||
                      (p.window > 0 && k0 <= sp.start + sp.t_last - p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * (lane % 4) + (e % 2);
          const int pos = qpos[e / 2];
          if (col > sp.hi) {
            s[n][e] = -INFINITY;  // past the live columns: weighs exactly 0
          } else if (col > pos || (p.window > 0 && col <= pos - p.window)) {
            s[n][e] = kMaskValue;
          }
        }
      }
    }
    acc.softmax(s);
    if constexpr (kQuant) {
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= vmul[buf * kCols + 8 * n + 2 * (lane % 4) + (e % 2)];
        }
      }
    }
    acc.accumulate(s, vtile, lane, kD / 16);
    if (t + 1 < n_tiles) store_scales((t + 1) % 2);
    __syncthreads();  // every warp is done with buffer t % 2
  }

  float l[2];
  acc.row_sums(l);
  const int rows_pad = row_tiles * kRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row0 + 8 * r;
    if (rr >= rows) continue;
    const int col = 2 * (lane % 4);
    if (p.splits == 1) {
      const int h = kvh * p.group + rr % p.group;
      T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh +
             (long long)(rr / p.group) * p.ot + col;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<typename tile::Op<T>::Pair*>(o + 8 * j) =
            tile::Op<T>::pair(acc.o[j][2 * r] * inv,
                              acc.o[j][2 * r + 1] * inv);
      }
    } else {
      const long long slot =
          (((long long)b * p.hkv + kvh) * p.splits + split) * rows_pad + rr;
      float* pa = p.part_acc + slot * kD + col;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<float2*>(pa + 8 * j) =
            make_float2(acc.o[j][2 * r], acc.o[j][2 * r + 1]);
      }
      if (lane % 4 == 0) {
        p.part_ml[slot * 2] = acc.m[r];
        p.part_ml[slot * 2 + 1] = l[r];
      }
    }
  }
}

// One thread per (token-major row, 4 columns): merges the partials of the
// splits that ran, in one online pass (m in the log2 domain, as the main
// kernel keeps it). The grid is (row tiles * 64 * Dh / 4 / 128, Hkv, B).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) paged_prefill_merge(Params p) {
  count_run(p.merge_runs);
  constexpr int kQuads = kD / 4;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int rr = i / kQuads;  // token-major row
  const int d = (i % kQuads) * 4;
  const int rows = p.t_q * p.group;
  if (rr >= rows) return;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int active = live_span(p, b, rr / kRows * kRows).active();
  const long long rows_pad = (long long)(rows + kRows - 1) / kRows * kRows;
  const long long base =
      ((long long)b * p.hkv + kvh) * p.splits * rows_pad + rr;
  float mx = kMaskValue, lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < active; ++j) {
    const long long slot = base + j * rows_pad;
    const float2 ml = *reinterpret_cast<const float2*>(p.part_ml + slot * 2);
    const float4 a =
        *reinterpret_cast<const float4*>(p.part_acc + slot * kD + d);
    const float m_new = fmaxf(mx, ml.x);
    const float c_old = tile::fast_exp2(mx - m_new);
    const float c = tile::fast_exp2(ml.x - m_new);
    lsum = lsum * c_old + c * ml.y;
    acc.x = acc.x * c_old + c * a.x;
    acc.y = acc.y * c_old + c * a.y;
    acc.z = acc.z * c_old + c * a.z;
    acc.w = acc.w * c_old + c * a.w;
    mx = m_new;
  }
  const float inv = 1.f / lsum;
  const int h = kvh * p.group + rr % p.group;
  T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh +
         (long long)(rr / p.group) * p.ot + d;
  using Pair = typename tile::Op<T>::Pair;
  Pair* o2 = reinterpret_cast<Pair*>(o);
  o2[0] = tile::Op<T>::pair(acc.x * inv, acc.y * inv);
  o2[1] = tile::Op<T>::pair(acc.z * inv, acc.w * inv);
}

template <typename T, typename P, int kD>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int ld = tile::Rows<T, kD>::ld;
  constexpr int ldp = kD + 16 / int(sizeof(P));
  size_t smem = sizeof(T) * size_t(kRows) * ld +
                sizeof(P) * size_t(4) * kCols * ldp;
  if (kQuant) {
    smem += sizeof(T) * size_t(2) * kCols * ld + sizeof(float) * 4 * kCols;
  }
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_mma<T, P, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.t_q * p.group + kRows - 1) / kRows;
  const dim3 grid(p.splits, row_tiles * p.hkv, batch);
  paged_prefill_mma<T, P, kD><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const int merge_ctas = (row_tiles * kRows * (kD / 4) + kThreads - 1) / kThreads;
  paged_prefill_merge<T, kD>
      <<<dim3(merge_ctas, p.hkv, batch), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// -- f32 q: the FMA loop ------------------------------------------------------

constexpr int kF32Rows = 32;
constexpr int kLanes = 4;  // threads per query row
constexpr int kF32Threads = kF32Rows * kLanes;
constexpr int kF32Cols = kCols / kLanes;  // scores per thread per K tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

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
  for (int base = 0; base < kTotal; base += kF32Threads * kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kF32Threads + tid;
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
      const int idx = base + u * kF32Threads + tid;
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

// P: the pool, float or int8_t (then scaled by p.sk / p.sv).
template <typename P, int kDh>
__global__ void __launch_bounds__(kF32Threads) paged_prefill_f32(Params p) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  extern __shared__ float fsmem[];
  count_run(p.runs);
  constexpr int ld = kDh + 1;
  float* qs = fsmem;                   // [kF32Rows][ld]
  float* ks = qs + kF32Rows * ld;      // [kCols][ld]
  float* vs = ks + kCols * ld;         // [kCols][ld]
  float* ps = vs + kCols * ld;         // [kF32Rows][kCols + 1]
  // Element offsets of the tile's K and V rows in the pool and of the
  // block's q rows (-1: none). The float count before them is even, so
  // they are 8-byte aligned.
  long long* koff = reinterpret_cast<long long*>(ps + kF32Rows * (kCols + 1));
  long long* voff = koff + kCols;
  long long* qoff = voff + kCols;
  // The tile rows' block scales (int8 pool).
  float* kmul = reinterpret_cast<float*>(qoff + kF32Rows);
  float* vmul = kmul + kCols;

  const int r0 = blockIdx.x * kF32Rows;  // first token-major row
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = p.t_q * p.group;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int start = p.start[b * p.start_stride];
  const int qpos = start + (r0 + row) / p.group;  // this row's position

  if (tid < kF32Rows) {
    const int r = r0 + tid;
    qoff[tid] = r < rows ? (kvh * p.group + r % p.group) * p.qh +
                               (long long)(r / p.group) * p.qt
                         : -1;
  }
  __syncthreads();
  stage_rows<float, kDh, kF32Rows>(static_cast<const float*>(p.q) + b * p.qb,
                                   qoff, nullptr, qs, ld, p.scale, tid);

  // The live columns of this block's rows: from the edge of the block that
  // holds the first row's window start through the last row's position.
  const int t_first = r0 / p.group;
  const int t_last = min((r0 + kF32Rows - 1) / p.group, p.t_q - 1);
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
  float* pr = ps + row * (kCols + 1);

  for (int k0 = c0; k0 <= hi; k0 += kCols) {
    __syncthreads();  // the previous tile's reads of ks/vs/offsets are done
    if (tid < kCols) {
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
    stage_rows<P, kDh, kCols>(k, koff, kQuant ? kmul : nullptr, ks, ld, 1.f,
                              tid);
    stage_rows<P, kDh, kCols>(v, voff, kQuant ? vmul : nullptr, vs, ld, 1.f,
                              tid);
    __syncthreads();

    float s[kF32Cols];
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
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
    for (int i = 0; i < kDh / kLanes; ++i) acc[i] *= alpha;
    const int live = min(kCols, hi - k0 + 1);
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
    float* o = static_cast<float*>(p.o) + b * p.ob + h * p.oh +
               (long long)(r / p.group) * p.ot;
#pragma unroll
    for (int i = 0; i < kDh / kLanes; ++i) {
      o[lane + i * kLanes] = acc[i] / l;
    }
  }
}

template <typename P, int kDh>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(kF32Rows + 2 * kCols) * (kDh + 1) +
                       size_t(kF32Rows) * (kCols + 1)) +
      sizeof(long long) * (2 * kCols + kF32Rows) +
      sizeof(float) * 2 * kCols;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_f32<P, kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = p.t_q * p.group;
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, p.hkv, batch);
  paged_prefill_f32<P, kDh><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// T: q's type; the pool is T, or int8 with scales.
template <typename T, typename P, int kDh>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_f32<P, kDh>(p, batch, stream);
  } else {
    return launch_mma<T, P, kDh>(p, batch, stream);
  }
}

template <typename T, typename P>
cudaError_t launch_dh(const Params& p, int batch, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch<T, P, 32>(p, batch, stream);
    case 64: return launch<T, P, 64>(p, batch, stream);
    case 128: return launch<T, P, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pool(const Params& p, bool int8_pool, int batch,
                        cudaStream_t stream) {
  return int8_pool ? launch_dh<T, int8_t>(p, batch, stream)
                   : launch_dh<T, T>(p, batch, stream);
}

}  // namespace

// dtype (q and o): 0 = float32, 1 = float16, 2 = bfloat16; pool_dtype: the
// same code as dtype, or 3 = int8, which needs scale_k / scale_v, f32
// [NB, Hkv] on the device. tables: int32 [B, MB] on the device; start:
// int32 on the device, start_stride 1 for one start per slot or 0 to
// broadcast one. strides: 17 element strides, (b, h, t) of q, (block, h,
// row) of pool_k, (block, h, row) of pool_v, b of tables, (b, h, t) of o,
// (block, h) of scale_k, (block, h) of scale_v (unused for a float pool);
// q and pool rows start on 16 bytes. window <= 0 means no window. splits:
// the split-K count for float16 / bfloat16 q (float32 q takes 1); above 1,
// part_acc / part_ml are f32 workspaces of B*Hkv*splits*R*Dh and
// B*Hkv*splits*R*2 floats, R = ceil(T*G/64)*64 (unused, may be null, with
// one split). runs: a device uint64 the kernel adds one to each time it
// runs; merge_runs: one the split-K merge adds one to each time it runs.
// Returns a cudaError_t value; 0 means launched.
extern "C" int defer_paged_flash_prefill(
    const void* q, const void* pool_k, const void* pool_v, void* o,
    const int* tables, const float* scale_k, const float* scale_v,
    const int* start, long long start_stride, float* part_acc,
    float* part_ml, int dtype, int pool_dtype, int batch, int hq, int hkv,
    int t_q, int bs, int mb, int dh, const long long* strides, int window,
    int splits, float scale, void* stream, unsigned long long* runs,
    unsigned long long* merge_runs) {
  const bool int8_pool = pool_dtype == 3;
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || t_q < 1 || bs < 1 ||
      mb < 1 || splits < 1 || batch > 65535 || (dtype == 0 && splits != 1) ||
      (long long)(t_q * (hq / hkv) + kRows - 1) / kRows * hkv > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (pool_dtype != dtype && !int8_pool) ||
      (int8_pool && (scale_k == nullptr || scale_v == nullptr)) ||
      runs == nullptr || merge_runs == nullptr) {
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
  p.part_acc = part_acc;
  p.part_ml = part_ml;
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
  p.hkv = hkv;
  p.group = hq / hkv;
  p.t_q = t_q;
  p.bs = bs;
  p.mb = mb;
  p.dh = dh;
  p.window = window;
  p.splits = splits;
  p.scale = scale;
  p.runs = runs;
  p.merge_runs = merge_runs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_pool<float>(p, int8_pool, batch, st));
    case 1: return int(launch_pool<__half>(p, int8_pool, batch, st));
    case 2:
      return int(launch_pool<__nv_bfloat16>(p, int8_pool, batch, st));
    default: return int(cudaErrorInvalidValue);
  }
}
