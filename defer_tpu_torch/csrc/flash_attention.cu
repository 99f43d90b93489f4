// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel defer_tpu/ops/pallas_attention.py::_flash_fwd_impl
// (body _mha_kernel, pallas_call at :134): softmax(q k^T * Dh^-0.5) v on
// (B, H, S, Dh) tensors, online softmax over K tiles with f32 m/l/acc,
// optional causal mask with the same finite mask value (-inf for the ragged
// columns past S), P rounded to q's type before P V, output acc / l cast to
// q's dtype.
//
// What bounds it on an H100: at BERT-base's shape (16, 12, 128, 64) bf16 the
// call moves 12.6 MB (q, k, v, o once each) and does 0.81 GFLOP: bytes,
// 3.8 us at 3.35 TB/s, over tensor-core operations, 0.8 us. At ViT-B/16's
// (32, 12, 197, 64) it is 11.6 us of bytes.
//
// Design for bf16 / f16 (attn_wgmma.cuh has the engine), against what held
// the sm_80 mma.sync tile back:
//   * Products on wgmma, asynchronous. One CTA = one (batch*head, 64-row
//     query tile) = one consumer warpgroup; an SM holds 4 of them at Dh
//     64, and their softmaxes run under each other's products. Within a
//     warpgroup, tile t's S = Q K^T and tile t - 1's O += P V are issued
//     as two groups back to back and retired together (wgmma_wait<0>)
//     before tile t's softmax. Running that softmax under the P V instead
//     raced (ptxas put tile t's P into the registers the in-flight P V was
//     reading; repeated calls differed), and was no faster. O is rescaled
//     before the P V it feeds; no wait or refill runs while a wgmma is in
//     flight.
//   * Copies by TMA. One elected thread loads Q once and keeps a ring of 2
//     K and 2 V stages full, each with a full mbarrier (the tile's bytes
//     as its expected transaction count) and an empty mbarrier (one arrival
//     per warp): tile t + 1 lands while tile t computes, and tile t + 2 is
//     requested as soon as every warp is done with t. The 128-byte swizzle
//     of the boxes is the layout the wgmma descriptors read. O / l goes
//     out the same way: into Q's swizzled tile, then one TMA store. Maps
//     are 4-D (Dh, S, H, B) over the caller's strides, so a head split of
//     a (B, S, H*Dh) projection is read and written in place.
//   * Ragged S. TMA zero-fills rows past S and columns past Dh, and every
//     K tile is scored at N = 64 with its columns past s_k masked to -inf:
//     at S = 197 the work is 256 x 256 where 197 x 197 is needed, 1.69x.
//     Scoring the last tile at the smallest N in {16, 32, 48} that covers
//     it (1.37x) picks the width at run time, and ptxas serializes the
//     wgmma of a kernel that branches between groups (C7520, C7511): that
//     build ran slower at ViT-B/16's shape than full tiles. Queries keep
//     wgmma's 64 rows.
//   * Short K loops: Q, K 0, V 0, K 1 and V 1 are requested at the CTA's
//     start, without a register or an instruction of the other threads. An
//     SM holds 4 CTAs (registers) at Dh 64.
//   * Causal: only the K tiles inside the triangle are visited, only the
//     diagonal tile and a ragged one are masked, and blockIdx.y runs the
//     query tiles from the last (the heaviest) to the first (the plan's
//     heaviest_first, set for causal calls).
//   * Host cost: the dynamic shared-memory limit is raised once per
//     instantiation and device, not on every launch; cuTensorMapEncodeTiled
//     is reached through cudaGetDriverEntryPoint, so the library links no
//     -lcuda.
//   * Any S >= 1 (s_q != s_k without the mask), Dh a multiple of 8 up to
//     128: both products run over the whole panel (64 or 128 columns, zeros
//     past Dh).
//
// The launch takes its tiling from the caller (ops/flash_attention.py's
// launch_plan): the panels of the head dim, the query tiles (the grid's
// y), the K tiles of a row and whether query tiles run heaviest first.
//
// f32 q, k, v keep an f32 FMA loop (flash_fwd_f32 below), chosen by dtype in
// defer_flash_attention_fwd. The tensor cores take f32 only as TF32 (about
// 3 decimal digits), which misses the f32 tolerance of 1e-5; no card path
// runs f32. Its layout: 4 threads a q row, K/V tiles staged as f32 rows of
// Dh + 1 floats, probabilities through shared memory.

#include <atomic>
#include <cmath>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"

namespace {

using wg::kBoxBytes;
using wg::kCols;
using wg::kLog2e;
using wg::kMaskValue;
using wg::kPanel;
using wg::kRowBytes;
using wg::kRows;

constexpr int kStages = 2;  // K (and V) tiles of the ring
constexpr int kThreads = 128;  // one consumer warpgroup

struct TileParams {
  int heads, s_q, s_k;
  float scale;  // Dh^-0.5 * log2(e)
  int causal;
  int k_tiles;         // K tiles of an unmasked query tile
  int heaviest_first;  // blockIdx.y 0 takes the last query tile
};

// The warpgroup's 64 query rows (wg::Acc; m unscaled, the scale riding in
// the exponent) and flash attention's softmax and epilogue.
template <typename T, int kPanels>
struct Rows : wg::Acc<T, kPanels> {
  using Base = wg::Acc<T, kPanels>;
  using Base::alpha;
  using Base::kD;
  using Base::l;
  using Base::m;
  using Base::o;
  using Base::p;
  using Base::s;

  // The online-softmax step on the retired scores of the tile at k0: mask,
  // new row max over the quad, l rescaled and extended, P (in q's type)
  // into buffer kBuf.
  // The scale into the log2 domain rides in the exponent's FMA (max and
  // mask commute with a positive scale). O is rescaled by `alpha` later,
  // before the P V it feeds.
  template <int kBuf>
  __device__ __forceinline__ void softmax(int k0, int q0, int row0, int lane,
                                          const TileParams& prm) {
    const bool ragged = k0 + kCols > prm.s_k;
    const bool diagonal = prm.causal && k0 + kCols - 1 > q0;
    if (ragged || diagonal) {
#pragma unroll
      for (int e = 0; e < kCols / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        if (col >= prm.s_k) {
          s[e] = -INFINITY;  // ragged edge: weighs exactly 0
        } else if (prm.causal && col > row) {
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
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = wg::fast_exp2((m[r] - mx[r]) * prm.scale);
      m[r] = mx[r];
      shift[r] = -mx[r] * prm.scale;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kCols / 2; ++e) {
      s[e] = wg::fast_exp2(fmaf(s[e], prm.scale, shift[(e / 2) % 2]));
      sum[(e / 2) % 2] += s[e];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      p[kBuf][kk][0] = wg::pack<T>(s[8 * kk], s[8 * kk + 1]);
      p[kBuf][kk][1] = wg::pack<T>(s[8 * kk + 2], s[8 * kk + 3]);
      p[kBuf][kk][2] = wg::pack<T>(s[8 * kk + 4], s[8 * kk + 5]);
      p[kBuf][kk][3] = wg::pack<T>(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }

  // O / l in q's type into the 128-byte-swizzled tile (Q's, which no wgmma
  // reads any more): row r's 16-byte chunk c sits at chunk c ^ (r % 8) of
  // its 128-byte row.
  __device__ __forceinline__ void store(unsigned char* tile, int warp,
                                        int lane) const {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[r] = 1.f / x;
    }
    const int g = lane / 4;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        const int off = (j / 8) * kBoxBytes + row * kRowBytes +
                        (((j % 8) ^ (row % 8)) * 16) + 4 * (lane % 4);
        *reinterpret_cast<uint32_t*>(tile + off) = wg::pack<T>(
            o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
};

template <typename T, int kPanels>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    const TileParams prm) {
  constexpr int kTile = kPanels * kBoxBytes;  // 64 rows, every panel
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  // Swizzled boxes start on 1024 bytes (the launch adds the slack).
  unsigned char* q_tile =
      smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = q_tile + kTile;        // [kStages] tiles
  unsigned char* vs = ks + kStages * kTile;  // [kStages] tiles

  const int b = blockIdx.x / prm.heads;
  const int h = blockIdx.x % prm.heads;
  // Heaviest first (the plan sets it for causal calls): blockIdx.y 0 takes
  // the last query tile, the one that walks the most K tiles under the
  // mask.
  const int q0 = (prm.heaviest_first ? gridDim.y - 1 - blockIdx.y
                                     : blockIdx.y) * kRows;
  const int n_k = prm.causal ? min(prm.k_tiles, q0 / kCols + 1)
                             : prm.k_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;
  // The elected thread that issues every copy.
  const bool leader = threadIdx.x == 0;

  if (leader) {
    wg::mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(k_full + st, 1);
      wg::mbar_init(v_full + st, 1);
      wg::mbar_init(k_empty + st, kThreads / 32);
      wg::mbar_init(v_empty + st, kThreads / 32);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  // K or V tile t into stage t % kStages, completing on its full barrier.
  auto load = [&](const CUtensorMap* map, unsigned char* ring,
                  uint64_t* full, int t) {
    const int st = t % kStages;
    wg::mbar_expect_tx(full + st, kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      wg::tma_load(ring + st * kTile + pn * kBoxBytes, map, full + st,
                   pn * kPanel, t * kCols, h, b);
    }
  };
  // Every warp has retired its reads of tile `done`: each arrives on the
  // stage's empty barrier, and the leader, once all have, loads tile
  // done + kStages into the stage.
  auto release = [&](const CUtensorMap* map, unsigned char* ring,
                     uint64_t* full, uint64_t* empty, int done) {
    const int st = done % kStages;
    if (lane == 0) wg::mbar_arrive(empty + st);
    if (leader && done + kStages < n_k) {
      wg::mbar_wait(empty + st, (done / kStages) & 1);
      load(map, ring, full, done + kStages);
    }
  };

  if (leader) {
    wg::mbar_expect_tx(q_full, kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      wg::tma_load(q_tile + pn * kBoxBytes, &tq, q_full, pn * kPanel, q0, h,
                   b);
    }
    for (int t = 0; t < min(kStages, n_k); ++t) {
      load(&tk, ks, k_full, t);
      load(&tv, vs, v_full, t);
    }
  }

  Rows<T, kPanels> rows;
  rows.init();
  wg::mbar_wait(q_full, 0);
  wg::mbar_wait(k_full, 0);
  rows.issue_qk(q_tile, ks);
  wg::wgmma_wait<0>();
  wg::hold(rows.s);
  release(&tk, ks, k_full, k_empty, 0);
  rows.template softmax<0>(0, q0, row0, lane, prm);
  // Tile t (P of tile t - 1 in buffer kPrev): its scores and tile t - 1's
  // P V issued back to back and retired together, then its softmax into
  // buffer 1 - kPrev. Retiring both before the softmax is what keeps it
  // off the registers of an in-flight wgmma: ptxas, given a softmax under
  // the P V, put tile t's P in the registers that P V was reading (SASS:
  // the exponentials' FFMA, MUFU and F2FP between the HGMMA and its
  // DEPBAR), and repeated calls differed.
  auto step = [&](auto prev, int t) {
    constexpr int kPrev = decltype(prev)::value;
    const int st = t % kStages;
    const int sp = (t - 1) % kStages;
    wg::mbar_wait(k_full + st, (t / kStages) & 1);
    wg::mbar_wait(v_full + sp, ((t - 1) / kStages) & 1);
    rows.rescale();
    rows.issue_qk(q_tile, ks + st * kTile);
    rows.template issue_pv<kPrev>(vs + sp * kTile);
    wg::wgmma_wait<0>();
    wg::hold(rows.s);
    rows.template softmax<1 - kPrev>(t * kCols, q0, row0, lane, prm);
    wg::hold(rows.o);
    wg::hold(rows.p[kPrev]);
    release(&tk, ks, k_full, k_empty, t);
    release(&tv, vs, v_full, v_empty, t - 1);
  };
  int t = 1;
  for (; t + 1 < n_k; t += 2) {
    step(std::integral_constant<int, 0>{}, t);
    step(std::integral_constant<int, 1>{}, t + 1);
  }
  if (t < n_k) {
    step(std::integral_constant<int, 0>{}, t);
    rows.move_p();  // the last tile's P is in buffer 1
  }
  const int sl = (n_k - 1) % kStages;
  wg::mbar_wait(v_full + sl, ((n_k - 1) / kStages) & 1);
  rows.rescale();
  rows.template issue_pv<0>(vs + sl * kTile);
  wg::wgmma_wait<0>();
  wg::hold(rows.o);

  // Every warp has retired its last wgmma before Q's tile takes O; the
  // generic writes are fenced before TMA reads them.
  __syncthreads();
  rows.store(q_tile, warp, lane);
  wg::fence_proxy_async();
  __syncthreads();
  if (leader) {
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      wg::tma_store(&to, q_tile + pn * kBoxBytes, pn * kPanel, q0, h, b);
    }
    wg::tma_store_commit_and_drain();
  }
}

// The 4-D map (Dh, S, H, B) of a (B, H, S, Dh) tensor with element strides
// (b, h, s) and a unit Dh stride, boxes of 64 rows x 64 columns in the
// 128-byte swizzle; reads past the tensor return zeros, writes past it are
// dropped.
bool encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
            int dh, int s, int heads, int batch, const long long* st) {
  static const wg::EncodeTiled fn =
      wg::driver_entry<wg::EncodeTiled>("cuTensorMapEncodeTiled");
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(s),
                              cuuint64_t(heads), cuuint64_t(batch)};
  // Byte strides of S, H and B; a dimension of extent 1 is never stepped,
  // so any legal stride stands for it.
  cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                           cuuint64_t(st[0]) * 2};
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = 16;
  }
  const cuuint32_t box[4] = {kPanel, kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kPanels>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[4], const TileParams& p,
                         int batch_heads, int q_tiles, cudaStream_t stream) {
  constexpr int kSmem = 1024 + (1 + 2 * kStages) * kPanels * kBoxBytes;
  static std::atomic<unsigned> ready{0};
  const cudaError_t err =
      wg::allow_smem(flash_fwd_wgmma<T, kPanels>, kSmem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, q_tiles);
  flash_fwd_wgmma<T, kPanels><<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// -- f32: the FMA loop ------------------------------------------------------

struct Strides {
  long long b, h, s;  // in elements; the Dh stride is 1
};

struct F32Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, s_q, s_k, dh;
  float scale;
  int causal;
};

constexpr int kLanes = 4;  // threads per q row
constexpr int kF32Threads = kRows * kLanes;
constexpr int kF32Cols = kCols / kLanes;  // scores per thread per K tile

template <int kMaxDh>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(F32Params p) {
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
cudaError_t launch_f32(const F32Params& p, int batch_heads,
                       cudaStream_t stream) {
  constexpr int kMaxSmem = sizeof(float) * (3 * kRows * (kMaxDh + 1) +
                                            kRows * (kCols + 1));
  static std::atomic<unsigned> ready{0};
  const cudaError_t err =
      wg::allow_smem(flash_fwd_f32<kMaxDh>, kMaxSmem, ready);
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * (size_t(3) * kRows * (p.dh + 1) +
                       size_t(kRows) * (kCols + 1));
  const dim3 grid(batch_heads, (p.s_q + kRows - 1) / kRows);
  flash_fwd_f32<kMaxDh><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_dh(const F32Params& p, int batch_heads,
                          cudaStream_t stream) {
  if (p.dh <= 32) return launch_f32<32>(p, batch_heads, stream);
  if (p.dh <= 64) return launch_f32<64>(p, batch_heads, stream);
  return launch_f32<128>(p, batch_heads, stream);
}

// The tiling of a 16-bit call, as the caller planned it.
struct Plan {
  int panels;          // 64-column boxes of the head dim: 1 or 2
  int q_tiles;         // 64-row query tiles: the grid's y
  int k_tiles;         // 64-column K/V tiles of an unmasked query tile
  int heaviest_first;  // blockIdx.y 0 takes the last query tile
};

// The launch of one call on the current device (the checks are the
// caller's). The f32 loop sizes its own grid and ignores `plan`.
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int dtype, int batch, int heads, int s_q, int s_k, int dh,
                   const long long* strides, float scale, int causal,
                   const Plan& plan, cudaStream_t stream) {
  const int bh = batch * heads;
  if (dtype == 0) {
    F32Params p;
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
    return launch_f32_dh(p, bh, stream);
  }
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, type, dh, s_q, heads, batch, strides) ||
      !encode(&maps[1], k, type, dh, s_k, heads, batch, strides + 3) ||
      !encode(&maps[2], v, type, dh, s_k, heads, batch, strides + 6) ||
      !encode(&maps[3], o, type, dh, s_q, heads, batch, strides + 9)) {
    return cudaErrorInvalidValue;
  }
  TileParams p;
  p.heads = heads;
  p.s_q = s_q;
  p.s_k = s_k;
  p.scale = scale * kLog2e;
  p.causal = causal;
  p.k_tiles = plan.k_tiles;
  p.heaviest_first = plan.heaviest_first;
  if (dtype == 1) {
    return plan.panels == 2
               ? launch_wgmma<__half, 2>(maps, p, bh, plan.q_tiles, stream)
               : launch_wgmma<__half, 1>(maps, p, bh, plan.q_tiles, stream);
  }
  return plan.panels == 2
             ? launch_wgmma<__nv_bfloat16, 2>(maps, p, bh, plan.q_tiles, stream)
             : launch_wgmma<__nv_bfloat16, 1>(maps, p, bh, plan.q_tiles,
                                              stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// strides: 12 element strides, (b, h, s) for q, k, v and o in that order;
// for float16 / bfloat16 every row must start on 16 bytes.
// panels, q_tiles, k_tiles, heaviest_first: the tiling of a float16 /
// bfloat16 call (ops/flash_attention.py's launch_plan); it must cover Dh,
// s_q and s_k.
// device: the CUDA device of the tensors; stream: a stream on it.
// Returns a cudaError_t value; 0 means the kernel was launched.
extern "C" int defer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int s_q, int s_k, int dh,
    const long long* strides, float scale, int causal, int panels,
    int q_tiles, int k_tiles, int heaviest_first, int device, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 || s_q < 1 || s_k < 1 || batch < 1 ||
      heads < 1 || (causal && s_q != s_k) ||
      (long long)(s_q + kRows - 1) / kRows > 65535) {
    return int(cudaErrorInvalidValue);
  }
  if (dtype != 0 &&
      (panels < 1 || panels > 2 || panels * kPanel < dh || q_tiles > 65535 ||
       (long long)q_tiles * kRows < s_q || (long long)k_tiles * kCols < s_k)) {
    return int(cudaErrorInvalidValue);
  }
  // The launch runs on `device` (wg::enter_device).
  int current = device;
  cudaError_t err = wg::enter_device(device, current);
  if (err != cudaSuccess) return int(err);
  err = launch(q, k, v, o, dtype, batch, heads, s_q, s_k, dh, strides, scale,
               causal, Plan{panels, q_tiles, k_tiles, heaviest_first},
               static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return int(err);
}
