// The tensor-core decode engine shared by flash_decode.cu and
// paged_flash_decode.cu (sm_90a): one query token per sequence, the G query
// rows of one KV head (padded to 16) against that head's live K/V rows.
// Only the address of a K/V row differs between the two kernels: contiguous
// in a cache, or through a block table into a pool (the `Src` policy).
//
// Work split. A (sequence, KV head, group of 16 query rows) is one thread
// block cluster of C CTAs (C <= 8, portable), launched by cudaLaunchKernelEx
// with a cluster dimension; C follows the shapes only (the wrapper's
// _cluster_size), never pos, so a launch needs no host sync. The live rows
// [lo, hi] are read from pos on the card and cut into 16-row slices from lo;
// a CTA has 4 warps, and warp w of rank r takes slices (4r + w) + k * 4C for
// k = 0, 1, ...: each rank takes every C-th 64-row tile of the live range,
// so the ranks' shares differ by at most one tile, and a 4096-row slot keeps
// its 8 CTAs busy on 8 tiles each while a 180-row slot's ranks take one
// slice a warp or none.
//
// Staging. Each warp is its own pipeline: a ring of kStages slices in shared
// memory, filled by 16-byte cp.async (K and V rows in the pool's type; an
// int8 pool as int8, half the bytes), kStages - 1 slices in flight while it
// computes one (4 warps x 2 slices x 8 KB = 64 KB a CTA at Dh 128 in bf16).
// A warp waits only on its own copies (cp.async.wait_group + __syncwarp), so
// no block-wide barrier sits in the loop. Through a block table, the table
// entries of a slice's rows are 4-byte cp.async copies into a small ring
// beside the data (lane r, row r; rows of one block share an address), made
// in the commit group of the slice kStages - 1 ahead of it: when a warp has
// waited for slice k, the entries of slice k + kStages - 1 have landed too,
// so no copy waits on a table load after the first. An int8 pool's two
// scales are copied the same way with the slice, by the lane of a block's
// first row in the slice (once a block), and each column reads its block's.
// Rows past hi, and table columns and scales outside [lo, hi], are never
// read: their copies are zero-fill copies of 0 source bytes, or none.
//
// Products. S = Q K^T and O += P V run on mma.sync m16n8k16 (attn_tile.cuh's
// pieces): Q as A fragments loaded once, K through ldmatrix and V through
// ldmatrix.trans. S is scaled in f32 by Dh^-0.5 * log2(e) (times the
// column's K scale on an int8 pool), the online softmax runs in the log2
// domain on the accumulators, P is rounded to the operand type (times the
// column's V scale) and reused from registers as the A fragment of P V.
// The operand type is q's on a float pool. On an int8 pool it is f16: the
// staged int8 words are widened in registers straight into B fragments
// (exact, 2 instructions a pair against bf16's 5, and no trip through
// shared memory; K takes the head dim in a permuted order that Q's A
// fragments share, V's columns are permuted and put back when O is
// written), bf16 q is moved into f16's range by a power of two per row,
// undone in f32 on S (exact but for elements 2^29 below their row's
// largest), and P, at most 1, rounds to f16 more finely than to bf16.
//
// Merge, in the same kernel. The 4 warps' (m, l, O) merge through shared
// memory into the CTA's state; then the cluster's C states merge through
// distributed shared memory (cluster.map_shared_rank) after cluster.sync(),
// each rank writing its share of the G x Dh outputs, and a last
// cluster.sync() keeps every CTA's shared memory alive until all reads are
// done. So a call is one kernel, with no f32 workspace and no second merge
// launch. A rank with no live slice skips the walk but stays for both
// barriers: its peers read its (empty) state, and a CTA may not leave while
// others may still read its shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "attn_tile.cuh"

namespace dtile {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;        // K/V rows a warp takes a step
constexpr int kQRows = 16;        // query rows of a CTA (one A fragment)
constexpr int kMaxCluster = 8;    // portable cluster size
using tile::kLog2e;
using tile::kMaskValue;

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

// The live rows [lo, hi] of a sequence whose last valid key is *pos: the TPU
// kernel's _decode_lo_hi in rows, cut to the `span` rows of the cache or
// table; window <= 0 means none.
struct Live {
  int lo, hi;
};

__device__ __forceinline__ Live live_range(const int* pos, int span,
                                           int window) {
  const int pb = *pos;
  return {window > 0 ? max(pb - window + 1, 0) : 0, min(pb, span - 1)};
}

// One CTA's merged state of kR query rows, read by its cluster peers.
template <int kR, int kD>
struct Partial {
  float m[kR];  // row max (log2 domain when kLog2, else natural)
  float l[kR];  // row sum of the probabilities
  float o[kR][kD];
};

// Every CTA of the cluster has written its state to `mine` (the same
// shared-memory offset in each). Rank r writes outputs r * n + t, r * n + t
// + C * n, ... (n threads, rows g < ng) as out[g * oh + d], in T.
template <typename T, int kR, int kD, bool kLog2>
__device__ __forceinline__ void cluster_merge(Partial<kR, kD>* mine, int ng,
                                              T* out, long long oh, int tid,
                                              int nthreads) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's state is written
  // The grid's x extent is the cluster, so blockIdx.x is the rank.
  const int c = int(gridDim.x);
  const int rank = int(blockIdx.x);
  const Partial<kR, kD>* peer[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    peer[r] = r < c ? cluster.map_shared_rank(mine, r) : mine;
  }
  for (int idx = rank * nthreads + tid; idx < ng * kD; idx += c * nthreads) {
    const int g = idx / kD;
    const int d = idx % kD;
    float m[kMaxCluster], l[kMaxCluster], o[kMaxCluster];
    float mx = kMaskValue;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c) {
        m[r] = peer[r]->m[g];
        l[r] = peer[r]->l[g];
        o[r] = peer[r]->o[g][d];
        mx = fmaxf(mx, m[r]);
      }
    }
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c) {
        const float w = kLog2 ? exp2f(m[r] - mx) : expf(m[r] - mx);
        lsum += w * l[r];
        osum += w * o[r];
      }
    }
    out[g * oh + d] = from_f32<T>(osum / lsum);
  }
  cluster.sync();  // no CTA leaves while a peer may read its state
}

// K/V rows of one cache slot: row r at k + r * ks.
template <typename P>
struct Contig {
  static constexpr bool kTable = false;
  const P* k;
  const P* v;
  long long ks, vs;
  __device__ __forceinline__ const P* k_row(int r) const { return k + r * ks; }
  __device__ __forceinline__ const P* v_row(int r) const { return v + r * vs; }
};

// n / d and n % d for 0 <= n < 2^24 and 1 <= d < 2^16 without the long
// instruction sequence of a division by a runtime value: n / d = (n * m) >>
// 40 with m = ceil(2^40 / d), exact since n * (m * d - 2^40) < n * d <
// 2^40.
struct FastDiv {
  unsigned long long m;
  int d;
  __host__ __device__ explicit FastDiv(int divisor = 1)
      : m(((1ull << 40) + unsigned(divisor) - 1) / unsigned(divisor)),
        d(divisor) {}
  __device__ __forceinline__ int div(int n) const {
    return int((unsigned long long)unsigned(n) * m >> 40);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// K/V rows of one slot through its block table: row r is row r % bs of pool
// block table[r / bs]; an int8 pool has one scale per (block, head).
template <typename P>
struct Paged {
  static constexpr bool kTable = true;
  const P* k;  // the KV head's rows: block e at k + e * kn
  const P* v;
  const int* table;
  const float* sk;  // the KV head's scales: block e at sk[e * skn]
  const float* sv;
  long long kn, ks, vn, vs, skn, svn;
  FastDiv bs;
  // Where row r's table entry lies.
  __device__ __forceinline__ const int* entry(int r) const {
    return table + bs.div(r);
  }
  // Row rib of block e.
  __device__ __forceinline__ const P* k_row(int e, int rib) const {
    return k + e * kn + rib * ks;
  }
  __device__ __forceinline__ const P* v_row(int e, int rib) const {
    return v + e * vn + rib * vs;
  }
  // Where block e's scales lie.
  __device__ __forceinline__ const float* k_scale(int e) const {
    return sk + e * skn;
  }
  __device__ __forceinline__ const float* v_scale(int e) const {
    return sv + e * svn;
  }
};

// Dynamic shared memory of one CTA, in bytes from its start: the query rows,
// the warps' rings (K then V a stage), and per warp an int8 pool's scale
// ring and the table entries' ring; after the walk, the warps' states and
// the CTA's Partial overlay the rings.
template <typename T, typename P, int kD, int kStages>
struct Layout {
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int ldq = kD + 8;  // T row, elements
  // A staged pool row, padded by 16 bytes: the 8 rows an ldmatrix or a
  // fragment load reads fall in 8 different bank groups.
  static constexpr int ldp = kD + 16 / int(sizeof(P));
  static constexpr int ldo = kD + 4;  // f32 state row
  static constexpr size_t q_bytes = sizeof(T) * kQRows * ldq;
  static constexpr size_t stage_bytes = sizeof(P) * 2 * kSlice * ldp;
  static constexpr size_t ring = q_bytes;
  static constexpr size_t ring_bytes = kWarps * kStages * stage_bytes;
  static constexpr size_t scales = ring + ring_bytes;
  static constexpr size_t scale_bytes =
      kQuant ? sizeof(float) * kWarps * kStages * 2 * kSlice : 0;
  static constexpr size_t ents = scales + scale_bytes;
  // [warp][stage][kEntArrays][kSlice]: each slice row's table entry and row
  // within its block; an int8 pool's column -> block-start row.
  static constexpr int kEntArrays = kQuant ? 3 : 2;
  static constexpr size_t ent_bytes =
      sizeof(int) * kWarps * kStages * kEntArrays * kSlice;
  static constexpr size_t bytes = ents + ent_bytes;
  // After the walk: warp states [kWarps][kQRows] m and l, O [kWarps][kQRows]
  // [ldo], then the CTA's Partial.
  static constexpr size_t states = ring;
  static constexpr size_t partial =
      states + sizeof(float) * kWarps * kQRows * (2 + ldo);
  static_assert(partial + sizeof(Partial<kQRows, kD>) <= bytes,
                "the merge state fits over the rings");
  static_assert(q_bytes % 16 == 0 && stage_bytes % 16 == 0 &&
                    partial % 16 == 0,
                "16-byte aligned regions");
};

// 4 bytes from global to shared memory without a register stop.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tile::smem_addr(dst)),
               "l"(src));
}

// int8 -> f16, exactly, two instructions a pair: the bytes b of u (already
// b ^ 0x80) at the byte selector `sel` (0x5140: bytes 0, 1; 0x5342: bytes
// 2, 3) become the halves 1024 + b, less 1024 + 128.
__device__ __forceinline__ uint32_t half_pair(uint32_t u, uint32_t sel) {
  uint32_t x = __byte_perm(u, 0x64646464u, sel);
  const __half2 v = __hsub2(*reinterpret_cast<__half2*>(&x),
                            __floats2half2_rn(1152.f, 1152.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 A fragments of Q -> f16 ones, each query row times 2^e_row so that
// its largest |q| lies in [2^14, 2^15): exact for every element within 2^29
// of its row's largest (f16's normal range), and 2^-e_row, to fold into
// the scores, in row_mul (rows g, g + 8 of the fragment layout).
template <int kK>
__device__ __forceinline__ void q_to_half(uint32_t (&qf)[kK][4],
                                          float (&row_mul)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][r]));
      mx[r % 2] = fmaxf(mx[r % 2], fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  float up[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // The exponent of the row's largest |q| (a zero row takes 0).
    const int e = mx[r] > 0.f ? 14 - ((__float_as_int(mx[r]) >> 23) - 127)
                              : 0;
    const int ec = max(-100, min(100, e));
    up[r] = exp2f(float(ec));
    row_mul[r] = exp2f(float(-ec));
  }
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][r]));
      qf[kk][r] = tile::pack<__half>(f.x * up[r % 2], f.y * up[r % 2]);
    }
  }
}

// The whole kernel body for 16-bit q: the query rows q + g * qh (g < ng)
// of one KV head attend its live rows [max(*pos - window + 1, 0),
// min(*pos, span - 1)] (window <= 0: from row 0) from `src`; rank
// blockIdx.x of the cluster walks its slices; the merged output row g goes
// to out + g * oh. `scale` is Dh^-0.5. Needs Layout<T, P, kD,
// kStages>::bytes of dynamic shared memory at `smem`.
template <typename T, typename P, int kD, int kStages, class Src>
__device__ __forceinline__ void attend(const Src& src, const T* q,
                                       long long qh, int ng, const int* pos,
                                       int span, int window, float scale,
                                       T* out, long long oh,
                                       unsigned char* smem) {
  using L = Layout<T, P, kD, kStages>;
  constexpr bool kQuant = L::kQuant;
  constexpr int ldq = L::ldq;
  constexpr int ldp = L::ldp;
  constexpr int kCpr = kD * int(sizeof(P)) / 16;  // 16-byte chunks a row
  constexpr int kPer = 16 / int(sizeof(P));       // elements a chunk
  constexpr int kRowStep = 32 / kCpr;             // rows a copy round covers
  constexpr int kRowsPer = kSlice / kRowStep;     // rows a lane copies
  static_assert(kCpr >= 2 && 32 % kCpr == 0, "a warp copies whole rows");
  static_assert(kD % 16 == 0, "Dh a multiple of 16");

  const int c = int(gridDim.x);  // the cluster: ranks 0 .. c - 1
  const int rank = int(blockIdx.x);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  T* qs = reinterpret_cast<T*>(smem);
  P* ring = reinterpret_cast<P*>(smem + L::ring) +
            warp * kStages * (L::stage_bytes / sizeof(P));
  // The products' operand type: q's, or f16 on an int8 pool (see half_pair
  // and q_to_half).
  using M = typename std::conditional<kQuant, __half, T>::type;
  // [stage][K, V][kSlice]: an int8 pool's scales, at the slice rows that
  // start a block.
  float* smul = reinterpret_cast<float*>(smem + L::scales) +
                warp * kStages * 2 * kSlice;
  // [stage][entry, row within its block, block-start row][kSlice]: what the
  // copies and an int8 pool's scales need of each slice row, the first two
  // per table stage, the third per data stage.
  constexpr int kEnt = L::kEntArrays * kSlice;
  int* ents = reinterpret_cast<int*>(smem + L::ents) + warp * kStages * kEnt;

  // The query rows, rows ng.. zero.
  {
    constexpr int kQChunks = kD / 8;
    for (int i = tid; i < kQRows * kQChunks; i += kThreads) {
      const int g = i / kQChunks;
      const int col = (i % kQChunks) * 8;
      tile::cp_async16(qs + g * ldq + col, q + (g < ng ? g * qh + col : 0),
                       g < ng ? 16 : 0);
    }
  }

  // The live rows, from pos on the card, read after the q copies are on
  // their way.
  const Live live = live_range(pos, span, window);
  const int lo = live.lo;
  const int hi = live.hi;

  // This warp's slices: j = gw + k * nw for k < cnt, rows lo + 16 j ...
  const int gw = rank * kWarps + warp;
  const int nw = c * kWarps;
  const int nslices = hi >= lo ? (hi - lo) / kSlice + 1 : 0;
  const int cnt = nslices > gw ? (nslices - gw + nw - 1) / nw : 0;
  auto slice_row = [&](int k) { return lo + kSlice * (gw + k * nw); };

  // The pipeline, in commit groups: group k holds the K/V rows (and an int8
  // pool's scales) of the warp's slice k and the table entries of its slice
  // k + kStages - 1, so each copy finds its rows' entries landed with the
  // group it waited for, kStages - 1 slices after they were asked for.
  // The one division by the block size a row takes is here.
  auto fetch_entries = [&](int k) {
    if constexpr (Src::kTable) {
      const int r = slice_row(k) + lane;
      if (k < cnt && lane < kSlice && r <= hi) {
        int* e = ents + (k % kStages) * kEnt + lane;
        cp_async4(e, src.entry(r));
        e[kSlice] = src.bs.mod(r);
      }
    }
  };
  auto copy = [&](int k) {
    const int s = k % kStages;
    P* kd = ring + s * 2 * kSlice * ldp;
    P* vd = kd + kSlice * ldp;
    const int r0 = slice_row(k);
#pragma unroll
    for (int u = 0; u < kRowsPer; ++u) {
      const int rr = lane / kCpr + u * kRowStep;  // row within the slice
      const bool live = r0 + rr <= hi;
      const int col = (lane % kCpr) * kPer;
      const P* krow = src.k;
      const P* vrow = src.v;
      if (live) {
        if constexpr (Src::kTable) {
          const int* e = ents + s * kEnt + rr;
          krow = src.k_row(e[0], e[kSlice]);
          vrow = src.v_row(e[0], e[kSlice]);
        } else {
          krow = src.k_row(r0 + rr);
          vrow = src.v_row(r0 + rr);
        }
      }
      tile::cp_async16(kd + rr * ldp + col, krow + (live ? col : 0),
                       live ? 16 : 0);
      tile::cp_async16(vd + rr * ldp + col, vrow + (live ? col : 0),
                       live ? 16 : 0);
    }
    if constexpr (kQuant) {
      // Lane r copies the two scales of row r's block where row r is the
      // first row of that block in the slice (once a block), and notes for
      // column r the slice row that starts its block.
      const int* e = ents + s * kEnt + lane;
      if (lane < kSlice && r0 + lane <= hi) {
        const int rib = e[kSlice];
        if (lane == 0 || rib == 0) {
          cp_async4(smul + s * 2 * kSlice + lane, src.k_scale(e[0]));
          cp_async4(smul + s * 2 * kSlice + kSlice + lane, src.v_scale(e[0]));
        }
        ents[s * kEnt + 2 * kSlice + lane] = lane - min(lane, rib);
      }
    }
  };

  // Prologue: q and the entries of slices 0 .. kStages - 2 (one group),
  // then those slices in flight with the entries of the next kStages - 1.
  // Without a table the slices need not wait for the first group.
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch_entries(k);
  tile::cp_async_commit();
  auto prologue = [&]() {
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < cnt) copy(k);
      __syncwarp();  // entry stage (k - 1) % kStages has been read
      fetch_entries(k + kStages - 1);
      tile::cp_async_commit();
    }
  };
  if constexpr (Src::kTable) {
    tile::cp_async_wait<0>();
  } else {
    prologue();
    tile::cp_async_wait<kStages - 1>();
  }
  __syncthreads();  // every warp's q rows have landed
  // Q's A fragments. On an int8 pool the head dim is taken in the order
  // that lets a thread's K values come from one 32-bit word of a staged
  // int8 row: in each 16-column step, the mma's k = 2i, 2i + 1, 2i + 8,
  // 2i + 9 are the columns 4i .. 4i + 3 (the same order on both sides of
  // the dot product).
  uint32_t qf[kD / 16][4];
  if constexpr (kQuant) {
    const T* base = qs + (lane / 4) * ldq + 4 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qf[kk][r] = *reinterpret_cast<const uint32_t*>(
            base + (r % 2) * 8 * ldq + 16 * kk + 2 * (r / 2));
      }
    }
  } else {
    const T* base = qs + (lane % 16) * ldq + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) tile::ldsm_x4(qf[kk], base + kk * 16);
  }
  float row_mul[2] = {1.f, 1.f};
  if constexpr (kQuant && std::is_same<T, __nv_bfloat16>::value) {
    q_to_half(qf, row_mul);
  }
  if constexpr (Src::kTable) prologue();

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};
  const float qk_scale = scale * kLog2e;

  for (int k = 0; k < cnt; ++k) {
    // Group k has landed (slice k, the entries of slice k + kStages - 1);
    // every lane is done with slice k - 1's stage.
    tile::cp_async_wait<kStages - 2>();
    __syncwarp();
    const int ahead = k + kStages - 1;
    if (ahead < cnt) copy(ahead);
    fetch_entries(ahead + kStages - 1);
    tile::cp_async_commit();  // possibly empty: keeps the group count even

    const int s = k % kStages;
    const P* kst = ring + s * 2 * kSlice * ldp;  // the slice's K rows
    const P* vst = kst + kSlice * ldp;           // and V rows

    // S = Q K^T: sc[n] holds key columns 8n + 2i, 8n + 2i + 1 of query rows
    // g (sc[n][0..1]) and g + 8 (sc[n][2..3]).
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if constexpr (kQuant) {
      // Thread (g, i) takes key rows g and g + 8, columns 4i .. 4i + 3 of
      // each 16-column step: one word each, widened in registers.
      const P* base = kst + (lane / 4) * ldp + 4 * (lane % 4);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
                                 base + n * 8 * ldp + 16 * kk) ^
                             0x80808080u;
          tile::Op<M>::mma(sc[n], qf[kk], half_pair(u, 0x5140),
                           half_pair(u, 0x5342));
        }
      }
    } else {
      const M* base =
          kst + ((lane % 8) + 8 * (lane / 16)) * ldp + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t bf[4];
        tile::ldsm_x4(bf, base + kk * 16);
        tile::Op<M>::mma(sc[0], qf[kk], bf[0], bf[1]);
        tile::Op<M>::mma(sc[1], qf[kk], bf[2], bf[3]);
      }
    }
    const int r0 = slice_row(k);
    const bool ragged = r0 + kSlice - 1 > hi;
    // An int8 pool's multipliers of this thread's 4 columns: the scales
    // stored at the slice row that starts each column's block; a column
    // past hi has none (its score is masked, its weight 0).
    float kmul[4], vmul[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kmul[e] = qk_scale;
      vmul[e] = 1.f;
      if constexpr (kQuant) {
        const int col = 8 * (e / 2) + 2 * (lane % 4) + (e % 2);
        if (r0 + col <= hi) {
          const int first = ents[s * kEnt + 2 * kSlice + col];
          kmul[e] *= smul[s * 2 * kSlice + first];
          vmul[e] = smul[s * 2 * kSlice + kSlice + first];
        } else {
          kmul[e] = vmul[e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + (e % 2);
        sc[n][e] *= kmul[2 * n + e % 2];
        if constexpr (kQuant) sc[n][e] *= row_mul[e / 2];
        if (ragged && r0 + col > hi) sc[n][e] = -INFINITY;  // weighs 0
      }
    }

    // The online-softmax step over the quad of each row.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = tile::fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = tile::fast_exp2(sc[n][e] - mx[e / 2]);
        sum[e / 2] += sc[n][e];
        if constexpr (kQuant) sc[n][e] *= vmul[2 * n + e % 2];
      }
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // O = O * alpha + P V.
    const uint32_t a[4] = {
        tile::pack<M>(sc[0][0], sc[0][1]), tile::pack<M>(sc[0][2], sc[0][3]),
        tile::pack<M>(sc[1][0], sc[1][1]), tile::pack<M>(sc[1][2], sc[1][3]),
    };
    if constexpr (kQuant) {
      // Column block cb of 32: its n-tile t holds the columns 32 cb + 4n + t
      // (n = 0 .. 7), so thread (g, i) widens one word of each of its four
      // key rows 2i, 2i + 1, 2i + 8, 2i + 9 (columns 32 cb + 4g .. + 3) into
      // the B fragments of all four n-tiles. The order is undone when O is
      // written out.
      const P* base = vst + 2 * (lane % 4) * ldp + 4 * (lane / 4);
#pragma unroll
      for (int cb = 0; cb < kD / 32; ++cb) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w[r] = *reinterpret_cast<const uint32_t*>(
                     base + ((r % 2) + 8 * (r / 2)) * ldp + 32 * cb) ^
                 0x80808080u;
        }
        // Bytes of key rows (2i, 2i + 1) and (2i + 8, 2i + 9) interleaved:
        // [t0 of row a, t0 of row b, t1 of a, t1 of b] and t2, t3 likewise.
        const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
        const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
        const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
        const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t sel = t % 2 ? 0x5342 : 0x5140;
          float(&acc)[4] = o[4 * cb + t];
          acc[0] *= alpha[0];
          acc[1] *= alpha[0];
          acc[2] *= alpha[1];
          acc[3] *= alpha[1];
          tile::Op<M>::mma(acc, a, half_pair(t < 2 ? lo01 : hi01, sel),
                           half_pair(t < 2 ? lo23 : hi23, sel));
        }
      }
    } else {
      const M* vbase =
          vst + ((lane % 8) + 8 * ((lane / 8) % 2)) * ldp + 8 * (lane / 16);
#pragma unroll
      for (int j = 0; j < kD / 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[2 * j + h][0] *= alpha[0];
          o[2 * j + h][1] *= alpha[0];
          o[2 * j + h][2] *= alpha[1];
          o[2 * j + h][3] *= alpha[1];
        }
        uint32_t bf[4];
        tile::ldsm_x4_trans(bf, vbase + 16 * j);
        tile::Op<M>::mma(o[2 * j], a, bf[0], bf[1]);
        tile::Op<M>::mma(o[2 * j + 1], a, bf[2], bf[3]);
      }
    }
  }

  // The warps' states into shared memory, over the rings.
  tile::cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem + L::states);  // [kWarps][16]
  float* wl = wm + kWarps * kQRows;                        // [kWarps][16]
  float* wo = wl + kWarps * kQRows;                 // [kWarps][16][ldo]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int g = lane / 4 + 8 * r;
    if (lane % 4 == 0) {
      wm[warp * kQRows + g] = m[r];
      wl[warp * kQRows + g] = x;
    }
    float* row = wo + (warp * kQRows + g) * L::ldo;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      if constexpr (kQuant) {  // n-tile j's columns 32 (j / 4) + 4n + j % 4
        const int d = 32 * (j / 4) + 8 * (lane % 4) + j % 4;
        row[d] = o[j][2 * r];
        row[d + 4] = o[j][2 * r + 1];
      } else {
        *reinterpret_cast<float2*>(row + 8 * j + 2 * (lane % 4)) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
    }
  }
  __syncthreads();

  // The CTA's state: its 4 warps merged.
  auto* part = reinterpret_cast<Partial<kQRows, kD>*>(smem + L::partial);
  for (int idx = tid; idx < ng * kD; idx += kThreads) {
    const int g = idx / kD;
    const int d = idx % kD;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kQRows + g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c_w = exp2f(wm[w * kQRows + g] - mx);
      lsum += c_w * wl[w * kQRows + g];
      osum += c_w * wo[(w * kQRows + g) * L::ldo + d];
    }
    part->o[g][d] = osum;
    if (d == 0) {
      part->m[g] = mx;
      part->l[g] = lsum;
    }
  }
  cluster_merge<T, kQRows, kD, true>(part, ng, out, oh, tid, kThreads);
}

// The largest cluster size c <= want at which all `clusters` clusters of a
// grid fit on the card at once (cudaOccupancyMaxActiveClusters for
// `kernel` with `threads` threads and `smem` bytes of dynamic shared
// memory), else 1: a second wave of clusters would double a short call's
// time, and a cluster's CTAs must share one GPC, so fewer clusters of 8
// fit than the SM count suggests. A device property and the shapes, never
// pos; `known` caches the counts of one kernel.
template <typename Params>
int fit_cluster(void (*kernel)(Params), int want, int clusters, int threads,
                size_t smem, int (&known)[kMaxCluster + 1]) {
  for (int c = want; c > 1; --c) {
    if (known[c] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 1, 1);
      cfg.blockDim = dim3(threads, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();  // a size the card refuses is skipped
        n = 0;
      }
      known[c] = n > 0 ? n : -1;
    }
    if (known[c] >= clusters) return c;
  }
  return 1;
}

// Launches `kernel` (one argument, `params`) on a grid whose x extent is the
// cluster size `c`, as clusters of (c, 1, 1).
template <typename Params>
cudaError_t launch_cluster(void (*kernel)(Params), const Params& params,
                           dim3 grid, int threads, size_t smem,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, params);
}

}  // namespace dtile
