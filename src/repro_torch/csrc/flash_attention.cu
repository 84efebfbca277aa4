// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py, `_fa_kernel`):
//
//   out[b, t, i] = sum_{j <= t} softmax_j(q[b, t, i] . k[b, j, i / G] / sqrt(D))
//                  v[b, j, i / G]
//
// for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D], G = Hq / Hkv (query and key
// positions both count from 0; `causal = 0` drops the j <= t mask).  As in
// the Pallas kernel the softmax runs online in float32 (running max m, sum
// l, accumulator acc), keys in a query's future are never visited, and the
// output is acc / max(l, 1e-20), rounded once to q's type.
//
// What bounds it: at the main path's shape (8 x 160 tokens, 32/8 heads,
// D = 128, bf16) reading Q, K, V and writing the output takes 7.8 us at
// 3.35 TB/s and the 1.7e9 flops of Q.K^T and P.V take 1.7 us on the bf16
// tensor cores, so bytes bound it; on the CUDA cores (67 TFLOP/s) the same
// flops would take 25 us.  So bf16 runs on the tensor cores, and the work
// of a block is short (at most five 32-key tiles at S = 160): what
// decides its time is the chain of dependent steps a tile.
//
// bf16, D in {64, 112, 128} and G <= 64: the Hopper body
// (`flash_wgmma_kernel`), on wgmma_tiles.cuh.
//
// * One block of one warpgroup per (batch * KV head, tile of 64 / G
//   positions): its 64 rows are the KV head's (position, query head)
//   pairs, one wgmma M tile, so the G query heads share every K/V tile
//   the block loads.  (Where G does not divide 64, as G = 5, the tile
//   holds 64 / G whole positions and its last rows are zeros.)  Heaviest
//   causal tiles first.
// * Thread 0 issues every copy by TMA: the Q tile once (a 5-D box of 64
//   columns x G heads x 64 / G positions out of [B][S][Hkv][G][D]), and
//   K and V tiles of kKeyTile keys through rings of kFwdStages stages
//   each (K's and V's apart: a tile's K is refilled once its Q.K^T is
//   done, its V once its P.V is), landing on mbarriers.  Tiles lie in
//   shared memory as TMA's 128-byte swizzle writes them: rows of 64
//   columns, a wider head dim in 64-column halves; D = 112 loads two
//   64-column boxes, the second zero-filled past column 112 by TMA
//   (padded in shared memory).
// * S = Q.K^T is a wgmma m64nBKk16 chain with both operands K-major in
//   shared memory; the bf16 products are exact, so S differs from the
//   float32 plain version only in summation order.
// * The online softmax runs on the accumulator fragments in log2 units
//   (exp2f, accurate to 2 ulp): a row's max and sum take two quad
//   shuffles.  The diagonal and ragged tiles are masked on fragment
//   coordinates; tiles wholly in the block's future are not loaded.
// * P.V keeps P accurate.  Rounding p once to bf16 (as fused attention
//   libraries do) puts about 10 % of outputs outside the bf16 bar of
//   1e-5 + 2^-7 |ref| against the float32 plain version, because its error
//   does not shrink with |out| (tests/test_torch_flash_numerics.py).  So p
//   is split into hi = bf16(p) and lo = bf16(p - hi), and P.V is two
//   wgmma per k16 step with A (hi, lo) from registers (the score
//   accumulators are the A fragment directly) and V MN-major in shared
//   memory, N = D in one instruction.
// * The latency chain of a tile (Q.K^T, softmax, P.V) is hidden by
//   several blocks an SM: 32-key tiles and two-stage rings keep a block
//   at 65 KB of shared memory and 122 registers a thread at D = 128, so
//   three are resident.
//   Overlapping inside the warpgroup (tile it + 1's Q.K^T in flight
//   during tile it's P.V and softmax) measured slower: ptxas serializes
//   wgmma chains whose accumulators other instructions read while one is
//   in flight (C7514).  64-key tiles hold two blocks an SM and measured
//   slower as well.
// * The epilogue divides by max(l, 1e-20), rounds once to bf16, stages
//   the tile swizzled in the spent Q tile and writes it by TMA (rows past
//   Sq and columns past D are dropped).
//
// bf16, D in {16, 32}, which a 128-byte swizzle row does not fit, and G >
// 64 at any D, where a 64-row tile holds no whole position: the mma.sync
// body (`flash_mma_kernel`): one block per (batch * KV
// head, 64 rows; 32 with 2 warps at G = 1), 32-key K and V tiles in a
// two-stage `cp.async` ring, rows padded by 16 bytes for `ldmatrix`, S and
// P.V (p split hi + lo) on `mma.sync.m16n8k16`, primitives in
// mma_tiles.cuh.  Which bf16 body runs is fixed by D and G in the
// launcher.
//
// float32 keeps the CUDA-core body below (one block per (batch * query
// head, 32 queries), 32-key float32 tiles in shared memory, FMA loops).
// The tensor cores take float32 only as TF32, whose 10-bit mantissa would
// break the float32 bar (5e-5) that the float32 callers are held to.
// Which body runs is fixed by the dtype; neither falls back to the other.
//
// Both bodies can also write `lse` [B, Hq, Sq] (float32, when its pointer
// is not null): the natural-log log-sum-exp of each row's scaled scores,
// m + log l (the bf16 body's m and l are in log2 units, so (m + log2 l) ln 2;
// the float32 body takes __logf, whose slow path would spill its registers).
// The backward (csrc/flash_attention_bwd.cu) recomputes p = exp(s - lse)
// from it.  The output does not depend on whether `lse` is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace mma_tiles;
using namespace wgmma_tiles;

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * D          // q
                          + static_cast<size_t>(kBlockK) * (D + 1)  // k
                          + static_cast<size_t>(kBlockK) * D);      // v
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                       int causal, float scale) {
  constexpr int kPerLane = (D + 31) / 32;  // output elements per lane
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;         // [kBlockK][D + 1]
  float* vs = ks + kBlockK * (D + 1);   // [kBlockK][D]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hq = bh - b * Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < kBlockQ * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int t = q0 + r;
    qs[e] = t < Sq
        ? to_f32(q[((static_cast<size_t>(b) * Sq + t) * Hq + hq) * D + d])
        : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int n = min(kBlockK, Sk - k0);
    __syncthreads();  // the previous tile (and the q load) are done with
    for (int e = tid; e < kBlockK * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      float kx = 0.0f, vx = 0.0f;
      if (j < n) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + k0 + j) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int t = q0 + r;
      // Warp-uniform skips: a row past the sequence, or a tile wholly in
      // this row's future (the Pallas kernel's masked update is a no-op).
      if (t >= Sq || (causal && k0 > t)) continue;
      const int key = k0 + lane;
      const bool valid = lane < n && (!causal || key <= t);
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + r * D;
        const float* kj = ks + lane * (D + 1);
        float dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        s = dot * scale;
      }
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float a = expf(m[i] - m_new);
      l[i] = l[i] * a + sum;
      m[i] = m_new;

      float pv[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) pv[c] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) pv[c] = fmaf(pj, vs[j * D + d], pv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc[i][c] = acc[i][c] * a + pv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    if (t >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * Hq + hq) * Sq + t] = m[i] + __logf(l[i]);
    T* orow = out + ((static_cast<size_t>(b) * Sq + t) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[i][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// W warps of 16 query rows per block: 4, or 2 where each row is its own
// position (G = 1), so that a causal tile spans 32 positions, not 64.
constexpr int kMmaBlockK = 32;  // keys per shared-memory tile
constexpr int kStages = 2;      // K/V tiles in the ring

// Shared memory of the bf16 kernel: the Q tile and kStages stages of K
// and V tiles, rows of D + 8 elements.
template <int D, int W>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(D + 8) *
         (16 * W + 2 * kStages * kMmaBlockK);
}

// One block of W warps per (batch * KV head, tile of 16 * W query rows).
// The rows of a (batch, KV head) are its Sq * G (position, query head)
// pairs, flat row f being position f / G of query head hk * G + f % G:
// the G query heads of a KV head share every K/V tile the block loads, and
// a causal tile spans 16 * W / G positions.  Tile index reversed so the longest causal tiles start
// first.
//
// Fragment coordinates (PTX m16n8k16): lane = 4 * g + c; a thread holds
// rows g and g + 8 of every 16 x 8 accumulator, columns 2c and 2c + 1.
template <int D, int W>
__global__ void __launch_bounds__(W * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int causal, float scale) {
  constexpr int kBlockRows = 16 * W;       // query rows per block
  constexpr int kStride = D + 8;           // elements per shared row
  constexpr int kChunks = D / 8;           // 16-byte chunks per row
  constexpr int kDSteps = D / 16;          // k16 steps over D (Q.K^T)
  constexpr int kDTiles = D / 8;           // n8 tiles over D (P.V)
  constexpr int kKTiles = kMmaBlockK / 8;  // n8 tiles over a key tile
  constexpr int kTileElems = kMmaBlockK * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBlockRows][kStride]
  bf16* ks = qs + kBlockRows * kStride;  // [kStages][kMmaBlockK][kStride]
  bf16* vs = ks + kStages * kTileElems;  // [kStages][kMmaBlockK][kStride]

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int n_rows = Sq * G;
  const int f0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  // Scores in log2 units: p = 2^(s * log2(e) - m), one exp2f each.
  const float scale2 = scale * 1.4426950408889634f;

  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  // Flat row f of this (b, hk) lives at qb + (f / G) * q_stride + (f % G) * D.
  const long long q_head0 =
      (static_cast<long long>(b) * Sq * Hq + static_cast<long long>(hk) * G) * D;
  const bf16* qb = q + q_head0;
  const bf16* kb = k + (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  const bf16* vb = v + (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  auto row_offset = [&](int f) -> long long {
    const int t = f / G;
    return t * q_stride + static_cast<long long>(f - t * G) * D;
  };

  // Group 0: the Q tile (rows past Sq * G zero-filled).
  for (int e = tid; e < kBlockRows * kChunks; e += W * 32) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    const bool in = f0 + r < n_rows;
    cp_async16(smem_addr(qs + r * kStride + ch * 8),
               in ? qb + row_offset(f0 + r) + ch * 8 : qb, in);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kMmaBlockK;
    bf16* kd = ks + stage * kTileElems;
    bf16* vd = vs + stage * kTileElems;
    for (int e = tid; e < kMmaBlockK * kChunks; e += W * 32) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const bool in = k0 + r < Sk;
      const long long off = in ? (k0 + r) * kv_stride + ch * 8 : 0;
      cp_async16(smem_addr(kd + r * kStride + ch * 8), kb + off, in);
      cp_async16(smem_addr(vd + r * kStride + ch * 8), vb + off, in);
    }
  };

  // Keys the block needs: causal rows stop at the block's last position.
  const int last_pos = (min(f0 + kBlockRows, n_rows) - 1) / G;
  const int k_end = causal ? min(Sk, last_pos + 1) : Sk;
  const int n_tiles = (k_end + kMmaBlockK - 1) / kMmaBlockK;
  // Groups 1 .. kStages - 1: the first tiles (empty groups past the last).
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t, t);
    cp_async_commit();
  }

  // The warp's flat rows are f0 + 16 * warp + [0, 16); this thread's two
  // are wf0 + g and wf0 + g + 8, at positions pos[0] and pos[1].  A warp
  // with no row inside Sq * G computes nothing.
  const int wf0 = f0 + 16 * warp;
  const int warp_pos0 = wf0 / G;
  const int pos[2] = {(wf0 + g) / G, (wf0 + g + 8) / G};
  // Keys this warp can see at all.
  const int warp_k_end =
      wf0 >= n_rows ? 0
      : causal      ? min(Sk, (min(wf0 + 16, n_rows) - 1) / G + 1)
                    : Sk;

  uint32_t qf[kDSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's columns only; summed at the end

  for (int it = 0; it < n_tiles; ++it) {
    // One group per tile: tile `it` is in once kStages - 2 are pending.
    cp_async_wait<kStages - 2>();
    // Q and tile `it` are visible to every warp, and every warp is done
    // with tile it - 1, whose stage the next load refills.
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      load_kv(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();  // possibly empty: keeps one group per tile

    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < kDSteps; ++kd)
        ldsm_x4(qf[kd], smem_addr(qs + (16 * warp + (lane & 15)) * kStride +
                                  kd * 16 + (lane >> 4) * 8));
    }
    const int k0 = it * kMmaBlockK;
    // Warp-uniform: a diagonal tile may lie wholly in this warp's future.
    if (k0 < warp_k_end) {
      const bf16* kt = ks + (it % kStages) * kTileElems;
      const bf16* vt = vs + (it % kStages) * kTileElems;
      // Key n8 tiles this warp needs: those starting before warp_k_end.
      const int live = min(kKTiles, (warp_k_end - k0 + 7) / 8);

      // S = Q.K^T: ldmatrix.x4 of 16 keys x 16 dims gives the B fragments
      // of two n8 key tiles.  The dims are the outer loop, so the pairs'
      // accumulator chains interleave; a diagonal tile whose second half
      // lies in the warp's future runs the first pair only.
      float s[kKTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      auto scores = [&](auto pairs) {
#pragma unroll
        for (int kd = 0; kd < kDSteps; ++kd) {
#pragma unroll
          for (int np = 0; np < decltype(pairs)::value; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, smem_addr(kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                           kStride +
                                  kd * 16 + ((lane >> 3) & 1) * 8));
            mma_bf16(s[2 * np], qf[kd], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qf[kd], bk[2], bk[3]);
          }
        }
      };
      static_assert(kKTiles == 4, "two pairs of n8 key tiles per tile");
      if (live > 2)
        scores(std::integral_constant<int, 2>{});
      else
        scores(std::integral_constant<int, 1>{});

      // Scale and mask: the causal diagonal, keys past Sk, and the key
      // tiles skipped above (their zero scores must not count).
      const bool masked = k0 + kMmaBlockK > warp_k_end ||
                          (causal && k0 + kMmaBlockK > warp_pos0 + 1);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale2;
          if (masked) {
            const int key = k0 + nt * 8 + 2 * c + (e & 1);
            if (key >= warp_k_end || (causal && key > pos[e >> 1])) x = kNegInf;
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      // Every row sees key 0, so after the first tile m is a real score:
      // masked entries give p = 0, and a row whose keys in this tile are
      // all masked keeps its m (alpha = 1).
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - m[e >> 1]);
          s[nt][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // acc += P.V with P = hi + lo: the accumulators of key tiles 2kk and
      // 2kk + 1 are the A fragment of k16 step kk; ldmatrix.trans of 16
      // keys x 16 dims gives the B fragments of two n8 dim tiles.
#pragma unroll
      for (int kk = 0; kk < kKTiles / 2; ++kk) {
        if (2 * kk >= live) break;
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, smem_addr(vt + (kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) *
                                               kStride +
                                      dp * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

  // Epilogue: l summed over the quad, acc / max(l, 1e-20) rounded once,
  // staged in the warp's own Q rows (no other warp reads them), then
  // 16-byte stores of the rows inside Sq.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-20f);
  }
  if (lse != nullptr && c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = wf0 + g + 8 * i;
      if (f < n_rows) {
        const int t = f / G;
        const long long row =
            (static_cast<long long>(b) * Hq + hk * G + (f - t * G)) * Sq + t;
        lse[row] = (m[i] + log2f(l[i])) * kLn2;
      }
    }
  }
  bf16* stage = qs + 16 * warp * kStride;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kStride + col) =
        __floats2bfloat162_rn(acc[i][0] / l[0], acc[i][1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kStride + col) =
        __floats2bfloat162_rn(acc[i][2] / l[1], acc[i][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = out + q_head0;
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    if (wf0 + r < n_rows)
      *reinterpret_cast<uint4*>(ob + row_offset(wf0 + r) + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// bf16, D in {64, 112, 128}: the Hopper body (wgmma, TMA)
// ---------------------------------------------------------------------------

constexpr int kRowTile = 64;    // (position, query head) rows a block: one wgmma M tile
constexpr int kKeyTile = 32;    // keys per K/V tile of the wgmma body
constexpr int kFwdStages = 2;   // K tiles, and V tiles, in their TMA rings
// blockIdx.x walks a KV head's row tiles, so the blocks in flight share
// their heads' K and V in L2; false: every KV head's heaviest row tile
// first, across the card.
constexpr bool kFwdTilesInner = false;

// 64-column halves of a row (the 128-byte swizzle's width): 1 at D = 64,
// 2 at D = 112 (the second zero-filled past column 112) and 128.
template <int D>
__host__ __device__ constexpr int halves() {
  return (D + 63) / 64;
}

template <int D, int BK, int S>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + static_cast<size_t>(halves<D>()) * 128 * (kRowTile + 2 * S * BK) +
         8 * (1 + 2 * S);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// One block of one warpgroup per (batch * KV head, tile of P = 64 / G
// positions): its R = P G rows are the (position, query head) pairs in
// flat order, one wgmma M tile (R = 64 where G divides 64; rows past R
// are zeros).  Tile index reversed so the longest causal tiles start
// first.  Thread 0 issues every TMA copy.
template <int D, int BK, int S>
__global__ void __launch_bounds__(128)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                   float scale) {
  static_assert(S >= 2, "a tile's K lands while the one before it computes");
  constexpr int kH = halves<D>();
  constexpr int kQHalf = kRowTile * 128;  // bytes of a 64-column half of the Q tile
  constexpr int kKVHalf = BK * 128;       // ... of a K or V tile
  constexpr int kDSteps = D / 16;         // k16 steps of Q.K^T (7 at D = 112)
  constexpr int kKSteps = BK / 16;        // k16 steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);     // [kH][64 rows][128 B]
  unsigned char* ks = qs + kH * kQHalf;         // [S][kH][BK keys][128 B]
  unsigned char* vs = ks + S * kH * kKVHalf;    // [S][kH][BK keys][128 B]
  // mbarriers: Q, then a K stage each, then a V stage each.
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + S * kH * kKVHalf);
  uint64_t* kbar = bars + 1;
  uint64_t* vbar = bars + 1 + S;

  const int G = Hq / Hkv;
  const int P = kRowTile / G;
  const int R = P * G;
  const int bh = kFwdTilesInner ? blockIdx.y : blockIdx.x;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int row_tile = kFwdTilesInner ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int t0 = row_tile * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int c = tid & 3;
  // Keys the block needs: causal rows stop at the block's last position.
  const int k_end = causal ? min(Sk, min(t0 + P, Sq)) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // Scores in log2 units: p = 2^(s * log2(e) - m), one exp2f each.
  const float scale2 = scale * 1.4426950408889634f;

  if (tid == 0) {
    for (int i = 0; i <= 2 * S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  if (R < kRowTile) {  // rows no box fills (G not dividing 64): zeros
    constexpr int kChunks = 8;  // 16-byte chunks a row
    const int n = kH * (kRowTile - R) * kChunks;
    for (int e = tid; e < n; e += 128) {
      const int h = e / ((kRowTile - R) * kChunks);
      const int rest = e - h * (kRowTile - R) * kChunks;
      *reinterpret_cast<uint4*>(qs + h * kQHalf + (R + rest / kChunks) * 128 +
                                (rest % kChunks) * 16) = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();

  // Tile `tile` of K (or V) into its ring's stage tile % S.
  auto load = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* bar, int tile) {
    const int st = tile % S;
    mbar_expect_tx(&bar[st], kH * kKVHalf);
    for (int h = 0; h < kH; ++h)
      tma_load_4d(ring + (st * kH + h) * kKVHalf, map, &bar[st], 64 * h, hk, tile * BK, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kH * R * 128);
    for (int h = 0; h < kH; ++h) tma_load_5d(qs + h * kQHalf, &tq, &bars[0], 64 * h, 0, hk, t0, b);
    for (int t = 0; t < S && t < n_tiles; ++t) {
      load(&tk, ks, kbar, t);
      load(&tv, vs, vbar, t);
    }
  }

  // This thread's rows 16 warp + g and + 8, at positions pos[0], pos[1].
  const int pos[2] = {t0 + (16 * warp + g) / G, t0 + (16 * warp + g + 8) / G};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's columns only; summed at the end
  float s[BK / 2];  // a tile's scores, then its p

  // S = Q.K^T of `tile` into s: K-major Q and K, k16 steps 32 bytes apart
  // within a 64-column half.
  auto issue_s = [&](int tile) {
    const int st = tile % S;
    mbar_wait(&kbar[st], (tile / S) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int h = kk / 4;
      const int off = (kk % 4) * 32;
      wgmma_ss<BK, 0>(s, desc_sw128(qs + h * kQHalf + off),
                      desc_sw128(ks + (st * kH + h) * kKVHalf + off), kk > 0);
    }
    wgmma_commit();
  };

  // The online softmax of tile `it`'s scores s (complete), in place: s
  // becomes p, m and l move on, alpha is the rescaling of what came before.
  // s[4 nt + e] is row 16 warp + g + 8 (e >> 1), key k0 + 8 nt + 2c + (e & 1);
  // the causal diagonal and keys past Sk are masked on those coordinates.
  float alpha[2];
  auto softmax = [&](int it) {
    const int k0 = it * BK;
    const bool masked = k0 + BK > k_end || (causal && k0 + BK - 1 > t0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale2;
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (key >= Sk || (causal && key > pos[(i >> 1) & 1])) x = kNegInf;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    // Every row sees key 0, so after the first tile m is a real score:
    // masked entries give p = 0, and a row whose keys in this tile are
    // all masked keeps its m (alpha = 1).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
  };

  // P = hi + lo as the A fragments of P.V: the p of key n8 tiles 2kk and
  // 2kk + 1 make k16 step kk.  Formed only while no wgmma is in flight
  // (ptxas serializes a chain whose register inputs change under it).
  uint32_t ph[kKSteps][4], pl[kKSteps][4];
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
  };

  // Every warp is done with tile `k_done`'s K and tile `v_done`'s V: their
  // stages take the tiles S on.
  auto refill = [&](int k_done, int v_done) {
    __syncthreads();
    if (tid == 0) {
      if (k_done >= 0 && k_done + S < n_tiles) load(&tk, ks, kbar, k_done + S);
      if (v_done >= 0 && v_done + S < n_tiles) load(&tv, vs, vbar, v_done + S);
    }
  };

  // Tile `it`, whose p is packed in ph / pl; nothing in flight on entry:
  // acc += P.V with V MN-major (a k16 step is 16 key rows, 2048 bytes;
  // the second 64-column half kKVHalf bytes on), N = D in one
  // instruction, then tile it + 1's Q.K^T and softmax.
  auto step = [&](int it) {
    const bool more = it + 1 < n_tiles;
    mbar_wait(&vbar[it % S], (it / S) & 1);
    const unsigned char* vt = vs + (it % S) * kH * kKVHalf;
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t dv = desc_sw128(vt + kk * 2048, kKVHalf);
      wgmma_rs<D, 1>(acc, ph[kk], dv, 1);
      wgmma_rs<D, 1>(acc, pl[kk], dv, 1);
    }
    wgmma_commit();
    if (more) {
      wgmma_wait<0>();
      issue_s(it + 1);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(it + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (more) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack();
    }
    refill(it + 1, it);
  };

  mbar_wait(&bars[0], 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack();
  refill(0, -1);
  for (int it = 0; it < n_tiles; ++it) step(it);

  // Epilogue: l summed over the quad, acc / max(l, 1e-20) rounded once,
  // staged swizzled in the spent Q tile, written by TMA (rows past Sq and
  // columns past D dropped).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-20f);
  }
  if (lse != nullptr && c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      if (r < R && pos[i] < Sq)
        lse[(static_cast<long long>(b) * Hq + hk * G + r % G) * Sq + pos[i]] =
            (m[i] + log2f(l[i])) * kLn2;
    }
  }
  __syncthreads();  // every warp's reads of the Q tile are done
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = 8 * nt + 2 * c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(qs + (col / 64) * kQHalf + sw128_offset(r, col % 64)) =
          __floats2bfloat162_rn(acc[4 * nt + 2 * i] / l[i], acc[4 * nt + 2 * i + 1] / l[i]);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int h = 0; h < kH; ++h) tma_store_5d(&to, qs + h * kQHalf, 64 * h, 0, hk, t0, b);
    tma_store_drain();
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * Hq, (Sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<float, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, Hq, Hkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int W>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, W>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (static_cast<long long>(Sq) * (Hq / Hkv) + 16 * W - 1) / (16 * W);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hkv, static_cast<unsigned>(tiles));
  flash_mma_kernel<D, W><<<grid, W * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, Hq, Hkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The four tensor maps of the wgmma body: q and out as [B][Sq][Hkv][G][D]
// in boxes of (64 columns, G heads, 1, P positions, 1), k and v as
// [B][Sk][Hkv][D] in boxes of (64, 1, BK keys, 1).
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int Sq, int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int P = kRowTile / G;
  const long long tiles = (Sq + P - 1) / P;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr uint64_t e = sizeof(bf16);
  const uint64_t q_dims[5] = {D, static_cast<uint64_t>(G), static_cast<uint64_t>(Hkv),
                              static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t q_strides[4] = {D * e, G * D * e, Hq * D * e,
                                 static_cast<uint64_t>(Sq) * Hq * D * e};
  const uint32_t q_box[5] = {64, static_cast<uint32_t>(G), 1, static_cast<uint32_t>(P), 1};
  const uint64_t kv_dims[4] = {D, static_cast<uint64_t>(Hkv), static_cast<uint64_t>(Sk),
                               static_cast<uint64_t>(B)};
  const uint64_t kv_strides[3] = {D * e, Hkv * D * e, static_cast<uint64_t>(Sk) * Hkv * D * e};
  const uint32_t kv_box[4] = {64, 1, kKeyTile, 1};
  CUtensorMap tq, tk, tv, to;
  int err = make_tensor_map(&tq, q, 5, q_dims, q_strides, q_box);
  if (err == 0) err = make_tensor_map(&to, out, 5, q_dims, q_strides, q_box);
  if (err == 0) err = make_tensor_map(&tk, k, 4, kv_dims, kv_strides, kv_box);
  if (err == 0) err = make_tensor_map(&tv, v, 4, kv_dims, kv_strides, kv_box);
  if (err != 0) return err;
  constexpr size_t smem = wgmma_smem_bytes<D, kKeyTile, kFwdStages>();
  auto kernel = flash_wgmma_kernel<D, kKeyTile, kFwdStages>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  if (kFwdTilesInner && B * Hkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = kFwdTilesInner ? dim3(static_cast<unsigned>(tiles), B * Hkv)
                                   : dim3(B * Hkv, static_cast<unsigned>(tiles));
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, to, lse, Sq, Sk, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, float* lse,
             int B, int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
             int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_f32<D>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 1:
      // The head dims a 128-byte swizzle row serves run on wgmma where a
      // 64-row tile holds a whole position (G <= 64); the rest keep the
      // mma.sync body.
      if constexpr (D >= 64) {
        if (Hq / Hkv <= kRowTile)
          return launch_wgmma<D>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s);
      }
      return Hq == Hkv
          ? launch_bf16<D, 2>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s)
          : launch_bf16<D, 4>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q and out [B, Sq, Hq, D], k and v [B, Sk, Hkv, D], all contiguous, of
// one type (dtype 0: float32, 1: bfloat16) and 16-byte aligned; D in {16,
// 32, 64, 112, 128}, Hq a multiple of Hkv.  `lse` is null or float32 [B,
// Hq, Sq], written with each row's log-sum-exp.  Launches on `stream` (PyTorch's
// current stream).  Returns the cudaError_t of the launch; 0 means it was
// queued.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int causal, float scale, int dtype,
                                      int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 32:
      return launch_d<32>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 64:
      return launch_d<64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 112:  // zamba2-7b: 3584 / 32 heads
      return launch_d<112>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 128:
      return launch_d<128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
