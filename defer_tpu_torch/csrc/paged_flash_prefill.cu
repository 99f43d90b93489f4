// Paged flash prefill for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel
// defer_tpu/ops/pallas_attention.py::paged_flash_prefill (body
// _paged_prefill_kernel, pallas_call at :769, live range _prefill_lo_hi): T
// query tokens per slot, q [B, Hq, T, Dh] at absolute positions start[b] ..
// start[b] + T - 1, against ONE layer of the paged KV pool, pool
// [NB, Hkv, bs, Dh], through the slot's block table [B, MB] (row r of slot b
// is row r % bs of pool block tables[b, r / bs]); the window's own K/V rows
// are already in the pool. Query rows are token-major: row r of a KV head's
// T*G rows is token r / G of query head kvh * G + r % G, and attends the
// columns <= start + r / G (and > start + r / G - window with a window).
// Scores times Dh^-0.5 in f32, f32 m/l/acc per row with the same finite mask
// value, P rounded to q's type before P V, output acc / l cast to q's dtype
// and stored [B, T, Hq, Dh]. The pool is q's dtype, or int8 with one f32
// scale per (block, KV head), scale_k/scale_v [NB, Hkv] (the TPU kernel's
// `quantized` path).
//
// What bounds it on an H100 (the SXM data sheet's 3.35 TB/s and 989
// TFLOP/s bf16, at its 700 W limit; chip_smoke.py phase 2 derives the
// bound from each call's inputs): at the main path's
// chunk (B 1, Hq 32, Hkv 8, T 64, Dh 128, 16-row blocks) the bytes, the live
// pool rows and q and o each moved once: 1.57 MB at start 64 (0.47 us),
// 9.4 MB at start 1984 (2.8 us), against 0.10 and 2.1 GFLOP of products
// (0.1 and 2.1 us). An int8 pool halves the pool bytes, and from a depth of
// about 1.5k columns the products bound it.
//
// Design for bf16 / f16 q (attn_wgmma.cuh has the engine), against what
// held the sm_80 tile back:
//   1. One launch a call, no workspace. A (row tile, KV head, slot) is one
//      thread block cluster of `splits` CTAs (at most 8, from shapes only,
//      never from start: the launch needs no host sync; the launch lowers
//      it until every cluster is resident at once), launched by
//      cudaLaunchKernelEx. Each rank walks a chunk of whole 64-column
//      tiles of the live range, two at least: a shallow chunk (the main
//      path's, one or two tiles deep) is rank 0's alone, which writes O
//      itself while the other ranks exit, with no merge and no cluster
//      barrier. Deeper, the ranks that walked tiles merge their f32
//      (m, l, O / l) through distributed shared memory after
//      cluster.sync(), every rank writing a share of the outputs from
//      loads issued at once; O is rounded to q's type once, on output.
//   2. The chain before the first product. A producer warp of its own
//      starts at once: its lanes read the table entries of a tile in
//      parallel (those of the next tile a tile ahead) and issue the TMA
//      copies; the consumers' loads of Q are in flight before the
//      barriers are set up (plain 16-byte loads, stored into the swizzled
//      layout: Q is read once a CTA, and a map would be encoded again
//      every call, q moving).
//   3. K/V re-read by each 64-row CTA of a KV head, as before, from L2:
//      two consumer warpgroups over one ring halve the reads but ran
//      slower at starts 64 and 1984 (PERF.md section 6), so a CTA holds
//      one, and an SM two CTAs on a float pool.
//   4. Products on wgmma, asynchronous: within a warpgroup, tile t's
//      S = Q K^T and tile t - 1's O += P V are issued back to back and
//      retired together before tile t's softmax (flash_attention.cu's
//      order, whose softmax under the P V raced), with P in two register
//      buffers that tiles take in turn. Copies by TMA: a ring of K and V
//      stages (2 to 4, as deep as shared memory allows), each with a full
//      mbarrier (expected bytes) and an empty one (one arrival a consumer
//      warp). No branch stands between wgmma
//      groups and no register is defined inside one (ptxas serializes
//      wgmma around either); tiles that meet the causal edge, the window's
//      edge or the end of the live range are masked after the groups
//      retire.
//   5. An int8 pool: TMA copies the int8 payload (a row of Dh bytes, in
//      128-byte rows); the consumers widen each tile to q's type, exactly
//      (|x| <= 127), into the swizzled tile the descriptors read, while the
//      next tiles' copies are in flight. The scales are folded per column:
//      S[:, c] times scale_k[block(c)], P[:, c] times scale_v[block(c)]
//      before P V; the producer loads a tile's scales once its copies are
//      issued, and the tile's full barriers wait for them too.
//
// K/V by TMA through the table: one 4-D map a pool tensor, dims (Dh, bs,
// Hkv, NB) from the pool's own strides, boxes of 64 head-dim columns (128
// bytes of int8) by R = gcd(bs, 64) rows. A 64-column tile is 64 / R boxes a
// panel, box i landing at i * R rows into the tile; with the 128-byte
// swizzle (bf16, f16) a box that starts inside a 1024-byte atom takes the
// atom's pattern from its address, so the stacked boxes are the layout of
// one 64-row box for any bs. A box past the live range is given a block
// past the pool: TMA fills it with zeros and reads nothing, and its columns
// are masked to -inf. The maps are cached on (pointer, shape, strides,
// dtype): a server's pool keeps its pointer, and an encode costs host time
// every call otherwise.
//
// f32 q keeps the f32 FMA loop (paged_prefill_f32 below, one CTA a 32-row
// tile, any pool), chosen by dtype in defer_paged_flash_prefill: the tensor
// cores take f32 only as TF32, which misses the f32 tolerance of 1e-5, and
// no card path runs f32. Its layout: 32 rows a CTA, 4 threads a row, K/V
// tiles widened to f32 in shared memory times a per-row block scale.

#include <cooperative_groups.h>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

using wg::kBoxBytes;
using wg::kCols;
using wg::kLog2e;
using wg::kMaskValue;
using wg::kPanel;
using wg::kRowBytes;
using wg::kRows;

constexpr int kMaxCluster = 8;   // portable cluster size: the most splits
constexpr int kMinChunk = 2;     // the fewest tiles a rank walks
constexpr int kMaxBoxes = 64;    // TMA boxes of a tile at most (bs 1)
constexpr int kI8Row = 128;      // bytes of a staged int8 row

struct Params {
  const void* q;
  const void* k;  // pool [NB, Hkv, bs, Dh] of one layer (the f32 loop's)
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
  int nb, hkv, group, t_q, bs, mb, dh, window;
  int box_shift;  // log2 of a TMA box's rows, gcd(bs, 64)
  float scale;    // Dh^-0.5
  unsigned long long* runs;  // the card's count of this kernel's runs
};

// One thread of the grid adds one to the card's count of runs, so a launch
// replayed from a captured CUDA graph is counted where it runs.
__device__ __forceinline__ void count_run(unsigned long long* runs) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    atomicAdd(runs, 1ull);
  }
}

// The live columns [c0, hi] of the token-major rows r0 .. r0 + rows - 1 of
// slot b and how many 64-column tiles they span from c0
// (ops/paged_flash_prefill.py's _live_span is the same arithmetic).
struct Span {
  int start, t_first, t_last, c0, hi, ntiles;
};

__device__ __forceinline__ Span live_span(const Params& p, int b, int r0,
                                          int rows) {
  Span s;
  s.start = p.start[b * p.start_stride];
  s.t_first = r0 / p.group;
  s.t_last = min((r0 + rows - 1) / p.group, p.t_q - 1);
  s.hi = min(s.start + s.t_last, p.mb * p.bs - 1);
  const int lo =
      p.window > 0 ? max(s.start + s.t_first - p.window + 1, 0) : 0;
  s.c0 = lo / p.bs * p.bs;
  s.ntiles = max(1, (s.hi - s.c0) / kCols + 1);
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
    res[2 * j] = wg::pack<T>(f[0], f[1]);
    res[2 * j + 1] = wg::pack<T>(f[2], f[3]);
  }
  out[0] = make_uint4(res[0], res[1], res[2], res[3]);
  out[1] = make_uint4(res[4], res[5], res[6], res[7]);
}

// What the softmax of a tile needs to mask this thread's two rows.
struct Mask {
  int hi;        // the last live column
  int qpos[2];   // the positions of rows g and g + 8
  int window;    // <= 0: none
  int causal;    // tiles ending past it meet a row's causal edge
  int low;       // tiles starting at or below it meet the window's edge
  int shift;     // log2 of a box's rows: column c's scale is box c >> shift
  float scale;   // Dh^-0.5 * log2(e) (a float pool's; kmul holds an int8
                 // pool's, times the K scales)
};

// A consumer warpgroup's 64 query rows (wg::Acc; m in log2 units) and the
// paged prefill's softmax.
template <typename T, int kPanels>
struct Rows : wg::Acc<T, kPanels> {
  using Base = wg::Acc<T, kPanels>;
  using Base::alpha;
  using Base::l;
  using Base::m;
  using Base::p;
  using Base::s;

  // The online-softmax step on the retired scores of the tile at k0, in
  // the log2 domain: scores times Dh^-0.5 * log2(e) (times the column's K
  // scale on an int8 pool, folded into kmul), the mask, the new row max
  // over the quad, l rescaled and extended, P (times an int8 pool's V
  // scale per column) in q's type into buffer kBuf; O is rescaled by
  // `alpha` later, before the P V it feeds. The mask is applied to scaled
  // scores and P is exp2(s - max): a rank whose share of a row is masked
  // throughout (its causal edge lies in another rank's tiles) holds
  // m = the mask value and P = 1 exactly, which the merge weighs 0.
  template <bool kQuant, int kBuf>
  __device__ __forceinline__ void softmax(int k0, const Mask& mk, int lane,
                                          const float* kmul,
                                          const float* vmul) {
#pragma unroll
    for (int e = 0; e < kCols / 2; ++e) {
      s[e] *= kQuant
                  ? kmul[(8 * (e / 4) + 2 * (lane % 4) + (e % 2)) >> mk.shift]
                  : mk.scale;
    }
    const bool edge = k0 + kCols - 1 > mk.hi || k0 + kCols - 1 > mk.causal ||
                      (mk.window > 0 && k0 <= mk.low);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kCols / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        const int pos = mk.qpos[(e / 2) % 2];
        if (col > mk.hi) {
          s[e] = -INFINITY;  // past the live columns: weighs exactly 0
        } else if (col > pos || (mk.window > 0 && col <= pos - mk.window)) {
          s[e] = kMaskValue;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = wg::fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kCols / 2; ++e) {
      s[e] = wg::fast_exp2(s[e] - mx[(e / 2) % 2]);
      sum[(e / 2) % 2] += s[e];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    if constexpr (kQuant) {
#pragma unroll
      for (int e = 0; e < kCols / 2; ++e) {
        s[e] *= vmul[(8 * (e / 4) + 2 * (lane % 4) + (e % 2)) >> mk.shift];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      p[kBuf][kk][0] = wg::pack<T>(s[8 * kk], s[8 * kk + 1]);
      p[kBuf][kk][1] = wg::pack<T>(s[8 * kk + 2], s[8 * kk + 3]);
      p[kBuf][kk][2] = wg::pack<T>(s[8 * kk + 4], s[8 * kk + 5]);
      p[kBuf][kk][3] = wg::pack<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

// Shared memory of a CTA: its Q tile, the K and V rings (an int8 pool's
// staged in 128-byte rows, then widened into one K tile and two V tiles of
// q's type, V t into buffer t % 2); after the walk the same bytes hold the
// CTA's partial state for its cluster peers. The rings are as deep as
// shared memory allows at the occupancy the launch bounds ask for: 4
// stages where a CTA has its SM (an int8 pool), 2 where two CTAs of 80 KB
// share one.
template <bool kQuant, int kPanels>
struct Layout {
  static constexpr int kStages = kQuant ? 4 : 2;
  static constexpr int kTile = kPanels * kBoxBytes;  // 64 rows, q's type
  static constexpr int kStage = kQuant ? kCols * kI8Row : kTile;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kStage;
  static constexpr int kWide = kV + kStages * kStage;  // int8: K, V, V
  static constexpr int kWalk = kWide + (kQuant ? 3 * kTile : 0);
  // A partial row: O / l in f32, 32 bytes of padding against bank
  // conflicts; then m and l.
  static constexpr int kLd = 4 * kPanel * kPanels + 32;  // bytes
  static constexpr int kPart = kRows * (kLd + 8);
  static constexpr int kBytes = 1024 + (kWalk > kPart ? kWalk : kPart);
};

// A CTA is one consumer warpgroup (warps 0-3) and a producer warp (warp
// 4). Two CTAs an SM on a float pool (ptxas then holds the kernel to 168
// registers, which it needs); one on an int8 pool, whose widening needs
// more (held to 168 it spilled, and a shallow chunk ran slower: PERF.md
// section 6).
constexpr int kConsumers = 128;
constexpr int kProducer = kConsumers / 32;  // the producer's warp
constexpr int kThreads = kConsumers + 32;

template <typename T, typename P, int kPanels>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<P, int8_t>::value ? 1 : 2)
    paged_prefill_wgmma(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  using L = Layout<kQuant, kPanels>;
  constexpr int kStages = L::kStages;
  constexpr int kD = kPanel * kPanels;
  // TMA boxes across the head dim: a 64-column panel each in q's type, one
  // 128-byte row of int8.
  constexpr int kBoxPanels = kQuant ? 1 : kPanels;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * kStages];
  // An int8 pool's per-box multipliers of the staged tiles.
  __shared__ float kmul[kQuant ? kStages : 1][kMaxBoxes];
  __shared__ float vmul[kQuant ? kStages : 1][kMaxBoxes];
  uint64_t* k_full = bars;
  uint64_t* v_full = bars + kStages;
  uint64_t* k_empty = bars + 2 * kStages;
  uint64_t* v_empty = bars + 3 * kStages;
  // Swizzled tiles start on 1024 bytes (the launch adds the slack).
  unsigned char* base =
      smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = base + L::kK;
  unsigned char* vs = base + L::kV;
  unsigned char* kw = base + L::kWide;
  unsigned char* vw = kw + L::kTile;  // [2] tiles
  unsigned char* part_o = base;  // [kRows][kLd bytes]
  float* part_m = reinterpret_cast<float*>(part_o + kRows * L::kLd);
  float* part_l = part_m + kRows;

  count_run(p.runs);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_tiles = gridDim.y / p.hkv;
  const int kvh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kRows;
  const int b = blockIdx.z;
  const int splits = gridDim.x;  // the cluster: ranks 0 .. splits - 1
  const int rank = blockIdx.x;
  const int rows = p.t_q * p.group;
  const Span sp = live_span(p, b, r0, kRows);
  const int chunk = max(kMinChunk, (sp.ntiles + splits - 1) / splits);
  const int active = (sp.ntiles + chunk - 1) / chunk;  // ranks with tiles
  const int n = max(0, min(chunk, sp.ntiles - rank * chunk));
  const int first = sp.c0 + rank * chunk * kCols;  // this rank's first column

  // A consumer's share of Q, token-major, by 16-byte loads, in flight
  // while the barriers are set up; the columns past Dh and the rows past
  // T * G are zeros.
  constexpr int kQChunks = kD / 8;
  constexpr int kQPer = kRows * kQChunks / 128;
  uint4 qv[kQPer];
  if (warp < kProducer && (rank == 0 || n > 0)) {  // rank 0 walks
    const T* q = static_cast<const T*>(p.q) + b * p.qb;
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = tid % 128 + 128 * u;
      const int r = i / kQChunks;
      const int c = i % kQChunks;
      const int rr = r0 + r;
      qv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (rr < rows && c * 8 < p.dh) {
        qv[u] = __ldg(reinterpret_cast<const uint4*>(
            q + (kvh * p.group + rr % p.group) * p.qh +
            (long long)(rr / p.group) * p.qt + c * 8));
      }
    }
  }

  // The producer's lane i copies box i (and i + 32) of each tile: its
  // first two tiles' pool blocks are loaded while the barriers are set up,
  // the later ones two tiles ahead.
  const int* table = p.tables + b * p.tb;
  const int rbox = 1 << p.box_shift;
  const int nbox = kCols >> p.box_shift;
  // A tile's pool blocks, a box's -1 past the live range.
  auto fetch = [&](int t, int (&blk)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const int col = first + t * kCols + i * rbox;
      blk[u] = i < nbox && col <= sp.hi ? __ldg(table + col / p.bs) : -1;
    }
  };
  int blk[2] = {-1, -1};   // tile t's
  int next[2] = {-1, -1};  // tile t + 1's
  if (warp == kProducer && n > 0) {
    if (lane == 0) {
      wg::prefetch_map(&tk);
      wg::prefetch_map(&tv);
    }
    fetch(0, blk);
    if (n > 1) fetch(1, next);
  }

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      // The producer arrives once with the tile's bytes, and once more on
      // an int8 pool when the tile's scales are in shared memory.
      wg::mbar_init(k_full + st, kQuant ? 2 : 1);
      wg::mbar_init(v_full + st, kQuant ? 2 : 1);
      wg::mbar_init(k_empty + st, kConsumers / 32);
      wg::mbar_init(v_empty + st, kConsumers / 32);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  Rows<T, kPanels> acc;
  if (warp == kProducer) {
    // The producer warp.
    const float scale = p.scale * kLog2e;
    auto copy = [&](const CUtensorMap* map, unsigned char* ring,
                    uint64_t* full, int t, const int (&bk)[2]) {
      const int st = t % kStages;
      if (lane == 0) wg::mbar_expect_tx(full + st, L::kStage);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        if (i < nbox) {
          const int col = first + t * kCols + i * rbox;
          // A box past the live range reads a block past the pool: zeros.
          const int blkc = bk[u] >= 0 ? bk[u] : p.nb;
#pragma unroll
          for (int pn = 0; pn < kBoxPanels; ++pn) {
            wg::tma_load(ring + st * L::kStage + pn * kBoxBytes +
                             i * rbox * kRowBytes,
                         map, full + st, pn * kPanel, col % p.bs, kvh, blkc);
          }
        }
      }
    };
    for (int t = 0; t < n; ++t) {
      const int st = t % kStages;
      int after[2] = {-1, -1};
      if (t + 2 < n) fetch(t + 2, after);  // two tiles ahead
      // An int8 pool's scales of the tile's blocks, in flight under the
      // copies.
      float ksc[2] = {0.f, 0.f}, vsc[2] = {0.f, 0.f};
      if constexpr (kQuant) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (blk[u] >= 0) {
            ksc[u] = __ldg(p.sk + blk[u] * p.skn + kvh * p.skh);
            vsc[u] = __ldg(p.sv + blk[u] * p.svn + kvh * p.svh);
          }
        }
      }
      if (t >= kStages) wg::mbar_wait(k_empty + st, (t / kStages - 1) & 1);
      copy(&tk, ks, k_full, t, blk);
      if (t >= kStages) wg::mbar_wait(v_empty + st, (t / kStages - 1) & 1);
      copy(&tv, vs, v_full, t, blk);
      if constexpr (kQuant) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = lane + 32 * u;
          if (i < nbox) {
            kmul[st][i] = ksc[u] * scale;
            vmul[st][i] = vsc[u];
          }
        }
        __syncwarp();
        if (lane == 0) {
          wg::mbar_arrive(k_full + st);
          wg::mbar_arrive(v_full + st);
        }
      }
      blk[0] = next[0];
      blk[1] = next[1];
      next[0] = after[0];
      next[1] = after[1];
    }
  } else if (n > 0) {
    // The consumer warpgroup.
    unsigned char* q_tile = base + L::kQ;
    {
      // Q, loaded above, into the 128-byte swizzle.
#pragma unroll
      for (int u = 0; u < kQPer; ++u) {
        const int i = tid % 128 + 128 * u;
        const int r = i / kQChunks;
        const int c = i % kQChunks;
        *reinterpret_cast<uint4*>(q_tile + (c / 8) * kBoxBytes +
                                  r * kRowBytes + ((c % 8) ^ (r % 8)) * 16) =
            qv[u];
      }
    }
    wg::fence_proxy_async();
    wg::bar_sync(1, kConsumers);

    Mask mk;
    const int row0 = r0 + 16 * warp + lane / 4;
    mk.hi = sp.hi;
    mk.qpos[0] = sp.start + row0 / p.group;
    mk.qpos[1] = sp.start + (row0 + 8) / p.group;
    mk.window = p.window;
    mk.causal = sp.start + sp.t_first;
    mk.low = sp.start + sp.t_last - p.window;
    mk.shift = p.box_shift;
    mk.scale = p.scale * kLog2e;

    // An int8 pool: the staged tile at src widened into dst, q's type in
    // the 128-byte swizzle; every consumer thread takes a share. The
    // staged rows hold zeros past Dh, so the tile does too.
    auto widen = [&](const unsigned char* src, unsigned char* dst) {
      constexpr int kW = kD / 16;  // 16-byte int8 chunks a row
      static_assert(kCols * kW % kConsumers == 0, "whole chunks a thread");
#pragma unroll
      for (int u = 0; u < kCols * kW / kConsumers; ++u) {
        const int i = tid + u * kConsumers;
        const int r = i / kW;
        const int c = 2 * (i % kW);  // its first 16-byte chunk of q's type
        uint4 out[2];
        widen16<T>(*reinterpret_cast<const uint4*>(src + r * kI8Row + 8 * c),
                   out);
        unsigned char* d = dst + (c / 8) * kBoxBytes + r * kRowBytes;
        *reinterpret_cast<uint4*>(d + ((c % 8) ^ (r % 8)) * 16) = out[0];
        *reinterpret_cast<uint4*>(d + (((c + 1) % 8) ^ (r % 8)) * 16) =
            out[1];
      }
    };
    // Tile t's K and V as the products read them.
    auto k_tile = [&](int t) {
      return kQuant ? kw : ks + (t % kStages) * L::kStage;
    };
    auto v_tile = [&](int t) {
      return kQuant ? vw + (t % 2) * L::kTile : vs + (t % kStages) * L::kStage;
    };
    // An int8 pool: tile t's staged K and V widened (the warpgroup has
    // retired its reads of the buffers they overwrite).
    auto widen_tile = [&](int t) {
      widen(ks + (t % kStages) * L::kStage, kw);
      widen(vs + (t % kStages) * L::kStage, vw + (t % 2) * L::kTile);
      wg::fence_proxy_async();
      wg::bar_sync(1, kConsumers);
    };
    auto release = [&](uint64_t* empty, int t) {
      if (lane == 0) wg::mbar_arrive(empty + t % kStages);
    };

    acc.init();
    wg::mbar_wait(k_full, 0);
    if constexpr (kQuant) {
      wg::mbar_wait(v_full, 0);
      widen_tile(0);
    }
    acc.issue_qk(q_tile, k_tile(0));
    wg::wgmma_wait<0>();
    wg::hold(acc.s);
    if constexpr (!kQuant) release(k_empty, 0);
    acc.template softmax<kQuant, 0>(first, mk, lane, kmul[0], vmul[0]);
    if constexpr (kQuant) {
      release(k_empty, 0);
      release(v_empty, 0);
    }
    // Tile t (P of tile t - 1 in buffer kPrev): its scores and tile
    // t - 1's P V issued back to back and retired together, then its
    // softmax into buffer 1 - kPrev. On an int8 pool tile t's K and V are
    // widened first, V a step before its P V, so the last P V waits for no
    // widening. The stages go back to the producer once nothing reads
    // them: an int8 pool's after the softmax that reads their scales.
    auto step = [&](auto prev, int t) {
      constexpr int kPrev = decltype(prev)::value;
      const int st = t % kStages;
      wg::mbar_wait(k_full + st, (t / kStages) & 1);
      if constexpr (kQuant) {
        wg::mbar_wait(v_full + st, (t / kStages) & 1);
        widen_tile(t);
      } else {
        wg::mbar_wait(v_full + (t - 1) % kStages, ((t - 1) / kStages) & 1);
      }
      acc.rescale();
      acc.issue_qk(q_tile, k_tile(t));
      acc.template issue_pv<kPrev>(v_tile(t - 1));
      wg::wgmma_wait<0>();
      wg::hold(acc.s);
      if constexpr (!kQuant) release(k_empty, t);
      acc.template softmax<kQuant, 1 - kPrev>(
          first + t * kCols, mk, lane, kmul[kQuant ? st : 0],
          vmul[kQuant ? st : 0]);
      wg::hold(acc.o);
      wg::hold(acc.p[kPrev]);
      if constexpr (kQuant) {
        release(k_empty, t);
        release(v_empty, t);
      } else {
        release(v_empty, t - 1);
      }
    };
    int t = 1;
    for (; t + 1 < n; t += 2) {
      step(std::integral_constant<int, 0>{}, t);
      step(std::integral_constant<int, 1>{}, t + 1);
    }
    if (t < n) {
      step(std::integral_constant<int, 0>{}, t);
      acc.move_p();  // the last tile's P is in buffer 1
    }
    if constexpr (!kQuant) {
      wg::mbar_wait(v_full + (n - 1) % kStages, ((n - 1) / kStages) & 1);
    }
    acc.rescale();
    acc.template issue_pv<0>(v_tile(n - 1));
    wg::wgmma_wait<0>();
    wg::hold(acc.o);
  }

  if (active == 1) {
    // One rank walked the live range (rank 0: a shallow chunk takes
    // kMinChunk tiles): its consumers write O / l, and no CTA reads
    // another's shared memory, so none waits at a cluster barrier.
    if (warp < kProducer && n > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = acc.l[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const float inv = 1.f / x;
        const int rr = r0 + 16 * warp + lane / 4 + 8 * r;
        if (rr >= rows) continue;
        T* o = static_cast<T*>(p.o) + b * p.ob +
               (kvh * p.group + rr % p.group) * p.oh +
               (long long)(rr / p.group) * p.ot + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          if (8 * j < p.dh) {
            *reinterpret_cast<uint32_t*>(o + 8 * j) = wg::pack<T>(
                acc.o[4 * j + 2 * r] * inv, acc.o[4 * j + 2 * r + 1] * inv);
          }
        }
      }
    }
    return;
  }

  // The CTA's partial state over the bytes of its tiles, once every
  // consumer has retired its last product, all in f32: O / l (l > 0 on
  // every row of a rank that walks, whose first column is live or masked
  // finite), m, and l summed over the quad.
  if (warp < kProducer) {
    wg::bar_sync(1, kConsumers);
    if (n > 0) {
      float lsum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = acc.l[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        lsum[r] = x;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        unsigned char* dst = part_o + row * L::kLd + 8 * (lane % 4);
        const float inv = 1.f / lsum[r];
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          *reinterpret_cast<float2*>(dst + 32 * j) = make_float2(
              acc.o[4 * j + 2 * r] * inv, acc.o[4 * j + 2 * r + 1] * inv);
        }
        if (lane % 4 == 0) {
          part_m[row] = acc.m[r];
          part_l[row] = lsum[r];
        }
      }
    }
  }

  // The merge: rank r writes 4-column chunks r * kThreads + tid, then every
  // splits * kThreads further, of the CTA's rows, from the states of the
  // ranks that walked tiles, read through distributed shared memory: the
  // sum of each rank's O / l times exp2(m - max) * l, over the sum of the
  // weights, in f32, rounded to q's type once. Every rank's loads are
  // issued at once (a rank past `active` reads this CTA's own bytes and is
  // weighed out by a select), so a chunk waits for one round trip, not one
  // a rank.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's state is written
  uint32_t peer[kMaxCluster];  // each rank's partial state, or this CTA's
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    peer[r] = wg::cluster_addr(base, r < active ? r : rank);
  }
  constexpr uint32_t kM = kRows * L::kLd;  // part_m from part_o
  constexpr uint32_t kL = kM + 4 * kRows;  // part_l
  const int dh4 = p.dh / 4;
  for (int idx = rank * kThreads + tid; idx < kRows * dh4;
       idx += splits * kThreads) {
    const int row = idx / dh4;
    const int c = idx % dh4;
    const int rr = r0 + row;
    if (rr >= rows) continue;
    float mv[kMaxCluster], lv[kMaxCluster];
    uint4 ov[kMaxCluster];
    const uint32_t o_off = row * L::kLd + 16 * c;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mv[r] = wg::ld_cluster(peer[r] + kM + 4 * row);
      lv[r] = wg::ld_cluster(peer[r] + kL + 4 * row);
      ov[r] = wg::ld_cluster16(peer[r] + o_off);
    }
    float mx = kMaskValue;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mx = r < active ? fmaxf(mx, mv[r]) : mx;
    }
    float lsum = 0.f;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      // The rank's weight of its normalized O: exp2(m - max) * l.
      const bool in = r < active;
      const float w = in ? wg::fast_exp2(mv[r] - mx) * lv[r] : 0.f;
      const uint32_t words[4] = {ov[r].x, ov[r].y, ov[r].z, ov[r].w};
      lsum += w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] += in ? w * __uint_as_float(words[e]) : 0.f;
      }
    }
    const float inv = 1.f / lsum;
    T* o = static_cast<T*>(p.o) + b * p.ob +
           (kvh * p.group + rr % p.group) * p.oh +
           (long long)(rr / p.group) * p.ot + 4 * c;
    *reinterpret_cast<uint2*>(o) = make_uint2(
        wg::pack<T>(a[0] * inv, a[1] * inv), wg::pack<T>(a[2] * inv, a[3] * inv));
  }
  cluster.sync();  // no CTA leaves while a peer may read its state
}

// The 4-D map (Dh, bs, Hkv, NB) of one pool tensor with element strides
// (block, head, row) and a unit Dh stride: boxes of 64 columns of q's type
// in the 128-byte swizzle, or 128 int8 columns unswizzled, by 2^box_shift
// rows; reads past the tensor return zeros. Maps are cached on what
// encodes them (the pool of a server keeps its pointer), a few at a time.
bool pool_map(CUtensorMap* map, const void* ptr, int code, int dh, int bs,
              int hkv, int nb, const long long* st, int box_shift) {
  struct Key {
    const void* ptr;
    long long v[8];
  };
  constexpr int kSlots = 16;
  static std::mutex mu;
  static Key keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0;
  const Key key = {ptr, {code, dh, bs, hkv, nb, st[0], st[1], st[2]}};
  // box_shift follows from bs.
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < kSlots; ++i) {
    bool same = keys[i].ptr == key.ptr;
    for (int j = 0; j < 8 && same; ++j) same = keys[i].v[j] == key.v[j];
    if (same) {
      *map = maps[i];
      return true;
    }
  }
  static const wg::EncodeTiled fn =
      wg::driver_entry<wg::EncodeTiled>("cuTensorMapEncodeTiled");
  if (fn == nullptr) return false;
  const bool int8 = code == 3;
  const int esize = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(bs),
                              cuuint64_t(hkv), cuuint64_t(nb)};
  // Byte strides of the row, head and block; a dimension of extent 1 is
  // never stepped, so any legal stride stands for it.
  cuuint64_t strides[3] = {cuuint64_t(st[2]) * esize,
                           cuuint64_t(st[1]) * esize,
                           cuuint64_t(st[0]) * esize};
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = 16;
  }
  const cuuint32_t box[4] = {cuuint32_t(int8 ? kI8Row : kPanel),
                             cuuint32_t(1 << box_shift), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
           : code == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap enc;
  if (fn(&enc, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  const int slot = used++ % kSlots;
  keys[slot] = key;
  maps[slot] = enc;
  *map = enc;
  return true;
}

// A launch configuration of `splits`-CTA clusters.
struct ClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterConfig(dim3 grid, int threads, int smem, cudaStream_t stream)
      : cfg() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid.x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, typename P, int kPanels>
cudaError_t launch_wgmma(const CUtensorMap& tk, const CUtensorMap& tv,
                         const Params& p, int splits, int batch,
                         cudaStream_t stream) {
  using L = Layout<std::is_same<P, int8_t>::value, kPanels>;
  static std::atomic<unsigned> ready{0};
  // Clusters of c CTAs resident on a card at once, by card and c (0: not
  // asked yet): a property of the card, cached for the first kMaxDevices.
  constexpr int kMaxDevices = 32;
  static std::atomic<int> fits[kMaxDevices][kMaxCluster + 1];
  auto kernel = paged_prefill_wgmma<T, P, kPanels>;
  const cudaError_t err = wg::allow_smem(kernel, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  int dev = 0;
  cudaGetDevice(&dev);  // allow_smem has read it already
  const int row_tiles = (p.t_q * p.group + kRows - 1) / kRows;
  const int clusters = row_tiles * p.hkv * batch;
  // The plan's cluster size, lowered until every cluster is resident at
  // once: a cluster's CTAs share one GPC, so fewer clusters fit than the
  // SM count suggests, and a second wave would double a short call.
  for (; splits > 1; --splits) {
    int fit = dev < kMaxDevices
                  ? fits[dev][splits].load(std::memory_order_relaxed)
                  : 0;
    if (fit == 0) {
      ClusterConfig probe(dim3(splits, 1, 1), kThreads, L::kBytes, nullptr);
      if (cudaOccupancyMaxActiveClusters(&fit, kernel, &probe.cfg) !=
              cudaSuccess ||
          fit < 1) {
        cudaGetLastError();  // a size the card refuses is skipped
        fit = -1;
      }
      if (dev < kMaxDevices) {
        fits[dev][splits].store(fit, std::memory_order_relaxed);
      }
    }
    if (fit >= clusters) break;
  }
  ClusterConfig launch(dim3(splits, row_tiles * p.hkv, batch), kThreads,
                       L::kBytes, stream);
  // One split: no rank reads another's shared memory, no cluster.
  if (splits == 1) launch.cfg.numAttrs = 0;
  return cudaLaunchKernelEx(&launch.cfg, kernel, tk, tv, p);
}

// A 16-bit call: the pool maps, then the instantiation of its head dim.
template <typename T, typename P>
cudaError_t launch_16(const Params& p, int pool_code, int splits, int batch,
                      cudaStream_t stream) {
  CUtensorMap tk, tv;
  const long long kst[3] = {p.kn, p.kh, p.ks};
  const long long vst[3] = {p.vn, p.vh, p.vs};
  if (!pool_map(&tk, p.k, pool_code, p.dh, p.bs, p.hkv, p.nb, kst,
                p.box_shift) ||
      !pool_map(&tv, p.v, pool_code, p.dh, p.bs, p.hkv, p.nb, vst,
                p.box_shift)) {
    return cudaErrorInvalidValue;
  }
  return p.dh == 128
             ? launch_wgmma<T, P, 2>(tk, tv, p, splits, batch, stream)
             : launch_wgmma<T, P, 1>(tk, tv, p, splits, batch, stream);
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
  constexpr int kSmem =
      sizeof(float) * ((kF32Rows + 2 * kCols) * (kDh + 1) +
                       kF32Rows * (kCols + 1)) +
      sizeof(long long) * (2 * kCols + kF32Rows) + sizeof(float) * 2 * kCols;
  static std::atomic<unsigned> ready{0};
  const cudaError_t err =
      wg::allow_smem(paged_prefill_f32<P, kDh>, kSmem, ready);
  if (err != cudaSuccess) return err;
  const int rows = p.t_q * p.group;
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, p.hkv, batch);
  paged_prefill_f32<P, kDh><<<grid, kF32Threads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_f32_dh(const Params& p, int batch, cudaStream_t stream) {
  switch (p.dh) {
    case 32: return launch_f32<P, 32>(p, batch, stream);
    case 64: return launch_f32<P, 64>(p, batch, stream);
    default: return launch_f32<P, 128>(p, batch, stream);
  }
}

cudaError_t launch(const Params& p, int dtype, int pool_code, int splits,
                   int batch, cudaStream_t stream) {
  const bool int8_pool = pool_code == 3;
  switch (dtype) {
    case 0:
      return int8_pool ? launch_f32_dh<int8_t>(p, batch, stream)
                       : launch_f32_dh<float>(p, batch, stream);
    case 1:
      return int8_pool
                 ? launch_16<__half, int8_t>(p, pool_code, splits, batch,
                                             stream)
                 : launch_16<__half, __half>(p, pool_code, splits, batch,
                                             stream);
    default:
      return int8_pool
                 ? launch_16<__nv_bfloat16, int8_t>(p, pool_code, splits,
                                                    batch, stream)
                 : launch_16<__nv_bfloat16, __nv_bfloat16>(
                       p, pool_code, splits, batch, stream);
  }
}

}  // namespace

// dtype (q and o): 0 = float32, 1 = float16, 2 = bfloat16; pool_dtype: the
// same code as dtype, or 3 = int8, which needs scale_k / scale_v, f32
// [NB, Hkv] on the device. tables: int32 [B, MB] on the device; start:
// int32 on the device, start_stride 1 for one start per slot or 0 to
// broadcast one. nb: the pool's blocks. strides: 17 element strides, (b, h,
// t) of q, (block, h, row) of pool_k, (block, h, row) of pool_v, b of
// tables, (b, h, t) of o, (block, h) of scale_k, (block, h) of scale_v
// (unused for a float pool); q and pool rows start on 16 bytes, and a 16-bit
// or int8 pool's strides are multiples of 16 bytes. window <= 0 means no
// window. splits: the plan of a float16 / bfloat16 call
// (ops/paged_flash_prefill.py's _prefill_plan), the CTAs of a cluster, 1 to
// 8; float32 q takes 1.
// device: the CUDA device of the tensors; stream: a stream on it. runs: a
// device uint64 the kernel adds one to each time it runs. Returns a
// cudaError_t value; 0 means launched.
extern "C" int defer_paged_flash_prefill(
    const void* q, const void* pool_k, const void* pool_v, void* o,
    const int* tables, const float* scale_k, const float* scale_v,
    const int* start, long long start_stride, int dtype, int pool_dtype,
    int batch, int hq, int hkv, int t_q, int nb, int bs, int mb, int dh,
    const long long* strides, int window, int splits, float scale,
    int device, void* stream, unsigned long long* runs) {
  const bool int8_pool = pool_dtype == 3;
  const int rows_cta = dtype == 0 ? kF32Rows : kRows;
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv || t_q < 1 || bs < 1 ||
      mb < 1 || nb < 1 || batch > 65535 || dtype < 0 || dtype > 2 ||
      (dh != 32 && dh != 64 && dh != 128) ||
      (dtype == 0 ? splits != 1 : splits < 1 || splits > kMaxCluster) ||
      (long long)(t_q * (hq / hkv) + rows_cta - 1) / rows_cta * hkv > 65535 ||
      (pool_dtype != dtype && !int8_pool) ||
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
  p.nb = nb;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.t_q = t_q;
  p.bs = bs;
  p.mb = mb;
  p.dh = dh;
  p.window = window;
  p.box_shift = 0;
  while (p.box_shift < 6 && bs % (2 << p.box_shift) == 0) ++p.box_shift;
  p.scale = scale;
  p.runs = runs;
  // The launch runs on `device` (wg::enter_device).
  int current = device;
  cudaError_t err = wg::enter_device(device, current);
  if (err != cudaSuccess) return int(err);
  err = launch(p, dtype, pool_dtype, splits, batch,
               static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return int(err);
}
