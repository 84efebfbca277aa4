// Backward of the causal GQA flash attention (csrc/flash_attention.cu) for
// Hopper (sm_90a).
//
// The Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py) has no backward:
// the JAX package trains through XLA's differentiation of its plain
// chunked attention.  The port runs the forward kernel on every cache-free
// causal path on the card, so training there needs this gradient.  For q
// [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], G = Hq / Hkv, the forward's output
// o and its row log-sum-exp lse [B, Hq, Sq] (natural log of the scaled
// scores), and the output gradient do:
//
//   p[t, j]  = exp(scale * q[t] . k[j] - lse[t])     (0 where j > t, causal)
//   D[t]     = sum_d do[t, d] o[t, d]
//   ds[t, j] = p[t, j] (do[t] . v[j] - D[t])
//   dv[j]    = sum_{t, heads of j's KV head} p[t, j] do[t]
//   dk[j]    = scale * sum_{t, heads} ds[t, j] q[t]
//   dq[t]    = scale * sum_j ds[t, j] k[j]
//
// accumulated in float32 and rounded once to the inputs' type.  Every sum
// is taken in a fixed order, so two calls on the same inputs give the same
// bits.
//
// What bounds it: at the training shape (8 x 512 tokens, 32/8 heads,
// D = 128, bf16, causal) the five products take 4.3e10 flops, 43 us on the
// bf16 tensor cores, and reading q, k, v, o, do and writing dq, dk, dv
// moves ~168 MB, 50 us at 3.35 TB/s: bytes bound it, by little, so the
// products have to run near the tensor cores' rate.  (The shipped design
// forms s and dp twice: seven products, 6.0e10 flops, 61 us.)
//
// bf16, D in {64, 112, 128}: the Hopper bodies, on wgmma_tiles.cuh; two
// launches, dq first.
//
// * `bwd_dq_wgmma_kernel`: the forward's block shape, one block of one
//   warpgroup per (batch * KV head, 64 (position, query head) rows), so
//   the G heads share each K/V tile; a KV head's row tiles dispatched
//   together, heaviest (causal) first (kDqTilesInner).  Thread
//   0 brings Q and dO once by TMA and kDqKeys-key K and V tiles through a
//   ring of kDqStages stages landing on mbarriers (tiles in TMA's 128-byte
//   swizzle; D = 112 as two 64-column boxes, the second zero-filled past
//   column 112).  It first forms its rows' D from O (device memory) and
//   dO (its staged tile) and writes it for the dK/dV blocks.  Per tile: s
//   = Q.K^T and dp = dO.V^T on wgmma (both operands K-major), p and ds on
//   the accumulator fragments (log2 units, MUFU ex2; the causal mask on
//   fragment coordinates), and dq += ds.K with ds, rounded once to bf16,
//   as the register A operand and K MN-major, N = D in one instruction.
//   dq is scaled, rounded once, staged swizzled and written by TMA.
// * `bwd_wgmma_kernel`: one block of one warpgroup per (batch, KV head,
//   tile of 64 keys), two resident an SM.  Its grid order adapts to the
//   shape: a KV head's key tiles dispatched together, heaviest (causal)
//   first, so the blocks in flight share their heads' Q and dO in L2; or,
//   where its longest block (G heads of items) is long against the work
//   an SM's slots get, every KV head's heaviest key tile first across the
//   card, so the longest blocks start first (kLongBlock).  K and V stay
//   in shared memory; items (query tile of 64 positions, query head) come
//   by TMA, Q and dO through a ring of kBwdStages stages, each row's lse
//   and D staged beside them.  s^T = K.Q^T and dp^T = V.dO^T on wgmma (M = the 64 keys,
//   N = the 64 rows); p^T and ds^T formed on the fragments and, rounded
//   once to bf16 (kSplitP, kSplitDs false), the register A operands of
//   dv += p^T.dO and dk += ds^T.Q with dO and Q MN-major.  dk and dv stay
//   in float32 registers across the G heads of the KV head, then are
//   staged swizzled in the K and V tiles and written by TMA.
// * Seven products, not five: each (key tile, query tile) forms s and dp
//   in both kernels.  A five-product design measured 2.5x slower
//   (PERF.md): the dK/dV blocks staged ds in shared memory and formed dq =
//   ds.K there, and the key tiles' float32 partials of a (head, query
//   tile) were summed in ascending key-tile order through a float32
//   workspace, each block waiting on a per-(batch, head, query tile)
//   counter for its predecessor; its per-element float32 adds and the
//   waits cost more than the two products they save.
// * p and ds enter the bf16 products rounded once.  Unlike the forward's
//   p.V, whose bar is per element, the backward is held to 2^-6 of each
//   gradient's largest value.  A CPU model of this arithmetic
//   (tests/test_torch_flash_bwd_numerics.py, which reads these two
//   constants) stays within half of that with one rounding, which adds
//   at most 2^-8 to the error of hi + lo (the final rounding to bf16
//   alone may take 2^-8): the split's second product in three of the
//   five products is not worth its time.
//
// bf16, D in {16, 32}, which a 128-byte swizzle row does not fit, and G
// > 64 at any D, where a 64-row tile holds no whole position: the earlier
// mma.sync body; two launches, dq first.
//
// * `bwd_dq_mma_kernel`: the forward's block shape, one block per (batch
//   * KV head, 64 (position, query head) rows; 32 with 2 warps at G = 1),
//   heaviest causal tiles first.  It first forms its rows' D from O and dO
//   and writes it for the dK/dV blocks (kDeltaInDq).  The warp's Q and dO
//   rows are A fragments in registers; 32-key K and V tiles stream through
//   a two-stage cp.async ring.  s = Q.K^T and dp = dO.V^T on mma.sync, ds
//   formed in registers is the A fragment of dq += ds.K.
// * `bwd_dkdv_mma_kernel`: one block of 4 warps per (batch, KV head, tile
//   of 64 keys), 16 keys a warp, over (query head, tile of 32 query rows)
//   items through a two-stage cp.async ring; s^T and dp^T on mma.sync with
//   the warp's K and V rows as the A operand, p^T and ds^T rounded once as
//   the A fragments of dv += p^T.dO and dk += ds^T.Q.
//
// Which bf16 body runs is fixed by D and G in the launcher, never by a
// failure.
//
// float32: the CUDA-core body, three launches (`bwd_delta_kernel`, one
// warp a row, first).  TF32 on the tensor cores would break the float32
// bar (1e-5 + 1e-4 |d|).
//
// * `bwd_dkdv_kernel`: one block per (batch, KV head, tile of 32 keys).
//   Its K and V tiles stay in shared memory while it loops over the G query
//   heads of the KV head and the query tiles at or after the key tile
//   (causal), so the GQA sum over heads stays in the block's registers.
// * `bwd_dq_kernel`: one block per (batch, query head, tile of 32 rows),
//   looping over the key tiles the rows can see.
//
// Both tile kernels recompute p and ds for a 32 x 32 tile the same way:
// each of the 4 warps takes 8 rows, each lane one key, and walks D four
// values at a time (rows broadcast from shared memory, the lane's key row
// padded by 4 floats so 16-byte loads of 8 lanes fall on distinct banks).
// ds goes to shared memory (rows padded to 33) for the products that
// follow, in which a lane owns a key (dk, dv) or a row (dq) and a warp a
// quarter of D.
//
// Which body runs is fixed by the dtype; neither falls back to the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace mma_tiles;
using namespace wgmma_tiles;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                 // rows of a query tile, keys of a key tile
constexpr int kRows = kTile / kWarps;     // rows per warp in the score step
constexpr int kPad = kTile + 1;           // row stride of the p / ds tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Shared memory of both tile kernels: the q, do, k and v tiles in float32
// ([kTile][D + 4] each), the p and ds tiles ([kTile][kPad]) and the rows'
// lse and D.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kTile) * (D + 4) +
                          2 * static_cast<size_t>(kTile) * kPad + 2 * kTile);
}

// Rows [r0, r0 + kTile) of a tensor whose rows are `stride` elements apart
// -> dst [kTile][D + 4] in float32; rows at or past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n) x = load4(src + (r0 + r) * stride + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

// lse and D of query rows [q0, q0 + kTile) of one (batch, head): 0 past Sq.
__device__ __forceinline__ void load_rows(float* lse_s, float* dlt_s,
                                          const float* lse, const float* dlt,
                                          long long bh, int q0, int Sq) {
  if (threadIdx.x < kTile) {
    const int t = q0 + threadIdx.x;
    const bool in = t < Sq;
    lse_s[threadIdx.x] = in ? lse[bh * Sq + t] : 0.0f;
    dlt_s[threadIdx.x] = in ? dlt[bh * Sq + t] : 0.0f;
  }
}

// p and ds of the tile (query rows q0 + i, keys k0 + j) into p_s / ds_s
// ([kTile][kPad]; p_s may be null): the warp's 8 rows against the lane's
// key.  Masked entries (causal future, rows past Sq, keys past Sk) are 0.
template <int D>
__device__ __forceinline__ void tile_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* dlt_s, float* p_s, float* ds_s, int q0,
    int k0, int Sq, int Sk, int causal, float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
  const float* kj = ks + lane * (D + 4);
  const float* vj = vs + lane * (D + 4);
  const float* q0p = qs + warp * kRows * (D + 4);
  const float* o0p = dos + warp * kRows * (D + 4);
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = load4(kj + d);
    const float4 v4 = load4(vj + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q4 = load4(q0p + r * (D + 4) + d);
      const float4 o4 = load4(o0p + r * (D + 4) + d);
      s[r] = fmaf(q4.x, k4.x, s[r]);
      s[r] = fmaf(q4.y, k4.y, s[r]);
      s[r] = fmaf(q4.z, k4.z, s[r]);
      s[r] = fmaf(q4.w, k4.w, s[r]);
      dp[r] = fmaf(o4.x, v4.x, dp[r]);
      dp[r] = fmaf(o4.y, v4.y, dp[r]);
      dp[r] = fmaf(o4.z, v4.z, dp[r]);
      dp[r] = fmaf(o4.w, v4.w, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp * kRows + r;
    const int t = q0 + i;
    const bool valid = t < Sq && key < Sk && (!causal || key <= t);
    const float p = valid ? expf(s[r] * scale - lse_s[i]) : 0.0f;
    if (p_s != nullptr) p_s[i * kPad + lane] = p;
    ds_s[i * kPad + lane] = p * (dp[r] - dlt_s[i]);
  }
}

// D[b, h, t] = sum_d do[b, t, h, d] o[b, t, h, d]: one warp per row, rows
// in memory order (b, t, h).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ dlt, int Sq, int Hq, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bt = row / Hq;
    const int t = static_cast<int>(bt % Sq);
    const long long b = bt / Sq;
    dlt[(b * Hq + h) * Sq + t] = acc;
  }
}

// dk, dv of one (batch, KV head, key tile).  Key tiles in order, so the
// causal tiles with the most query tiles start first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dlt,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
                int Hkv, int causal, float scale) {
  constexpr int kDW = D / kWarps;  // dims per warp in the products
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 4);
  float* ks = dos + kTile * (D + 4);
  float* vs = ks + kTile * (D + 4);
  float* p_s = vs + kTile * (D + 4);
  float* ds_s = p_s + kTile * kPad;
  float* lse_s = ds_s + kTile * kPad;
  float* dlt_s = lse_s + kTile;

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  load_tile<T, D>(ks, k + kv_off, kv_stride, k0, Sk);
  load_tile<T, D>(vs, v + kv_off, kv_stride, k0, Sk);

  float dk_acc[kDW], dv_acc[kDW];
#pragma unroll
  for (int c = 0; c < kDW; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  // Causal: rows before k0 see none of the tile's keys.
  const int q_first = causal ? (k0 / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long bh = static_cast<long long>(b) * Hq + h;
    const long long q_off = (static_cast<long long>(b) * Sq * Hq + h) * D;
    for (int q0 = q_first; q0 < Sq; q0 += kTile) {
      __syncthreads();  // the previous tile's products are done with qs, dos, p, ds
      load_tile<T, D>(qs, q + q_off, q_stride, q0, Sq);
      load_tile<T, D>(dos, dout + q_off, q_stride, q0, Sq);
      load_rows(lse_s, dlt_s, lse, dlt, bh, q0, Sq);
      __syncthreads();
      tile_scores<D>(qs, dos, ks, vs, lse_s, dlt_s, p_s, ds_s, q0, k0, Sq, Sk,
                     causal, scale);
      __syncthreads();
      // dv[j] += sum_i p[i, j] do[i], dk[j] += sum_i ds[i, j] q[i] for the
      // lane's key j over the warp's dims.
      const float* qd = qs + warp * kDW;
      const float* od = dos + warp * kDW;
      const int rows = min(kTile, Sq - q0);
      for (int i = 0; i < rows; ++i) {
        const float p = p_s[i * kPad + lane];
        const float ds = ds_s[i * kPad + lane];
#pragma unroll
        for (int c = 0; c < kDW; c += 4) {
          const float4 o4 = load4(od + i * (D + 4) + c);
          const float4 q4 = load4(qd + i * (D + 4) + c);
          dv_acc[c] = fmaf(p, o4.x, dv_acc[c]);
          dv_acc[c + 1] = fmaf(p, o4.y, dv_acc[c + 1]);
          dv_acc[c + 2] = fmaf(p, o4.z, dv_acc[c + 2]);
          dv_acc[c + 3] = fmaf(p, o4.w, dv_acc[c + 3]);
          dk_acc[c] = fmaf(ds, q4.x, dk_acc[c]);
          dk_acc[c + 1] = fmaf(ds, q4.y, dk_acc[c + 1]);
          dk_acc[c + 2] = fmaf(ds, q4.z, dk_acc[c + 2]);
          dk_acc[c + 3] = fmaf(ds, q4.w, dk_acc[c + 3]);
        }
      }
    }
  }

  const int key = k0 + lane;
  if (key < Sk) {
    T* dkr = dk + kv_off + key * kv_stride + warp * kDW;
    T* dvr = dv + kv_off + key * kv_stride + warp * kDW;
#pragma unroll
    for (int c = 0; c < kDW; c += 4) {
      store4(dkr + c, make_float4(dk_acc[c] * scale, dk_acc[c + 1] * scale,
                                  dk_acc[c + 2] * scale, dk_acc[c + 3] * scale));
      store4(dvr + c, make_float4(dv_acc[c], dv_acc[c + 1], dv_acc[c + 2],
                                  dv_acc[c + 3]));
    }
  }
}

// dq of one (batch, query head, query tile).  Tile index reversed, so the
// causal tiles that see the most keys start first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlt,
              T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
              float scale) {
  constexpr int kDW = D / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 4);
  float* ks = dos + kTile * (D + 4);
  float* vs = ks + kTile * (D + 4);
  float* ds_s = vs + kTile * (D + 4) + kTile * kPad;
  float* lse_s = ds_s + kTile * kPad;
  float* dlt_s = lse_s + kTile;

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x - b * Hq;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  const long long q_off = (static_cast<long long>(b) * Sq * Hq + h) * D;
  load_tile<T, D>(qs, q + q_off, q_stride, q0, Sq);
  load_tile<T, D>(dos, dout + q_off, q_stride, q0, Sq);
  load_rows(lse_s, dlt_s, lse, dlt, static_cast<long long>(b) * Hq + h, q0, Sq);

  float dq_acc[kDW];
#pragma unroll
  for (int c = 0; c < kDW; ++c) dq_acc[c] = 0.0f;

  // Causal: keys past the tile's last row are in every row's future.
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's product is done with ks, ds
    load_tile<T, D>(ks, k + kv_off, kv_stride, k0, Sk);
    load_tile<T, D>(vs, v + kv_off, kv_stride, k0, Sk);
    __syncthreads();
    tile_scores<D>(qs, dos, ks, vs, lse_s, dlt_s, nullptr, ds_s, q0, k0, Sq,
                   Sk, causal, scale);
    __syncthreads();
    // dq[i] += sum_j ds[i, j] k[j] for the lane's row i over the warp's dims.
    const float* kd = ks + warp * kDW;
    const int keys = min(kTile, Sk - k0);
    for (int j = 0; j < keys; ++j) {
      const float ds = ds_s[lane * kPad + j];
#pragma unroll
      for (int c = 0; c < kDW; c += 4) {
        const float4 k4 = load4(kd + j * (D + 4) + c);
        dq_acc[c] = fmaf(ds, k4.x, dq_acc[c]);
        dq_acc[c + 1] = fmaf(ds, k4.y, dq_acc[c + 1]);
        dq_acc[c + 2] = fmaf(ds, k4.z, dq_acc[c + 2]);
        dq_acc[c + 3] = fmaf(ds, k4.w, dq_acc[c + 3]);
      }
    }
  }

  const int t = q0 + lane;
  if (t < Sq) {
    T* dqr = dq + q_off + t * q_stride + warp * kDW;
#pragma unroll
    for (int c = 0; c < kDW; c += 4)
      store4(dqr + c, make_float4(dq_acc[c] * scale, dq_acc[c + 1] * scale,
                                  dq_acc[c + 2] * scale, dq_acc[c + 3] * scale));
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

// p and ds enter the bf16 products rounded once (not split into hi + lo).
constexpr bool kSplitP = false;
constexpr bool kSplitDs = false;
constexpr int kKvKeys = 64;            // keys per dK/dV block: 16 a warp
constexpr int kKvWarps = kKvKeys / 16;
constexpr int kQRows = 32;             // query rows per item of the dK/dV loop
constexpr int kKeyTile = 32;           // keys per K/V tile of the dQ loop
// D = sum dO.O of each row is formed by the dQ kernel, which holds the
// rows' dO already and runs first, rather than by its own launch.
constexpr bool kDeltaInDq = true;
constexpr float kLog2e = 1.4426950408889634f;

// p = 2^x by `ex2` (wgmma_tiles.cuh): exp2f's extra range handling costs
// 2 % of the backward's time, and p is rounded to bf16 next.

// (x0, x1) as the A-fragment pair of a bf16 product: hi = bf16(x) and, when
// split, lo = bf16(x - hi).
template <bool Split>
__device__ __forceinline__ void to_operand(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (Split)
    split_bf16(x0, x1, hi, lo);
  else
    hi = as_u32(__floats2bfloat162_rn(x0, x1));
}

// acc + the dot product of 8 bf16 pairs (16 bytes each), in float32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// Shared memory of the dK/dV kernel: the K and V tiles, two stages of Q
// and dO tiles (rows of D + 8 elements) and of their rows' lse and D.
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(D + 8) * (2 * kKvKeys + 4 * kQRows) +
         sizeof(float) * 4 * kQRows;
}

// Shared memory of the dQ kernel: the Q and dO rows of the block and two
// stages of K and V tiles.
template <int D, int W>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(D + 8) * (2 * 16 * W + 4 * kKeyTile);
}

// dk, dv of one (batch, KV head, tile of kKvKeys keys).
template <int D>
__global__ void __launch_bounds__(kKvWarps * 32)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dlt,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                    int Hq, int Hkv, int causal, float scale) {
  constexpr int kThreadsKv = kKvWarps * 32;
  constexpr int kStride = D + 8;          // elements per shared row
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int kDSteps = D / 16;         // k16 steps over D (s^T, dp^T)
  constexpr int kDTiles = D / 8;          // n8 tiles over D (dv, dk)
  constexpr int kQTiles = kQRows / 8;     // n8 tiles over an item's rows
  constexpr int kTileElems = kQRows * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [kKvKeys][kStride]
  bf16* vs = ks + kKvKeys * kStride;               // [kKvKeys][kStride]
  bf16* qs = vs + kKvKeys * kStride;               // [2][kQRows][kStride]
  bf16* dos = qs + 2 * kTileElems;                 // [2][kQRows][kStride]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileElems);  // [2][kQRows]
  float* dlt_s = lse_s + 2 * kQRows;                              // [2][kQRows]

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kKvKeys;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const float scale2 = scale * kLog2e;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;

  // Group 0: the K and V tiles (zero past Sk).
  for (int e = tid; e < kKvKeys * kChunks; e += kThreadsKv) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    const bool in = k0 + r < Sk;
    const long long off = kv_off + (in ? (k0 + r) * kv_stride + ch * 8 : 0);
    cp_async16(smem_addr(ks + r * kStride + ch * 8), k + off, in);
    cp_async16(smem_addr(vs + r * kStride + ch * 8), v + off, in);
  }
  cp_async_commit();

  // Items (query head, tile of kQRows rows), heads outer; causal: the
  // tiles from the key tile's first position on.
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  const int qt0 = causal ? min(k0 / kQRows, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int items = G * per_head;
  auto item_rows = [&](int item, int& h, int& q0) {
    const int gh = item / per_head;
    h = hk * G + gh;
    q0 = (qt0 + item - gh * per_head) * kQRows;
  };
  auto load_item = [&](int item, int stage) {
    int h, q0;
    item_rows(item, h, q0);
    const long long q_off = (static_cast<long long>(b) * Sq * Hq + h) * D;
    bf16* qd = qs + stage * kTileElems;
    bf16* od = dos + stage * kTileElems;
    for (int e = tid; e < kQRows * kChunks; e += kThreadsKv) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const bool in = q0 + r < Sq;
      const long long off = q_off + (in ? (q0 + r) * q_stride + ch * 8 : 0);
      cp_async16(smem_addr(qd + r * kStride + ch * 8), q + off, in);
      cp_async16(smem_addr(od + r * kStride + ch * 8), dout + off, in);
    }
    if (tid < kQRows) {
      const bool in = q0 + tid < Sq;
      const long long row =
          (static_cast<long long>(b) * Hq + h) * Sq + (in ? q0 + tid : 0);
      cp_async4(smem_addr(lse_s + stage * kQRows + tid), lse + row, in);
      cp_async4(smem_addr(dlt_s + stage * kQRows + tid), dlt + row, in);
    }
  };
  // Group 1: the first item.
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  // The warp's keys are kw + [0, 16); this thread's kw + g and kw + g + 8.
  const int kw = k0 + 16 * warp;
  const uint32_t k_rows = smem_addr(ks + (16 * warp + (lane & 15)) * kStride + (lane >> 4) * 8);
  const uint32_t v_rows = smem_addr(vs + (16 * warp + (lane & 15)) * kStride + (lane >> 4) * 8);
  // ldmatrix offsets (elements) of the B fragments of two n8 tiles: plain
  // (rows are the n dimension) and transposed (rows are the k dimension).
  const int b_plain = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
  const int b_trans = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  for (int it = 0; it < items; ++it) {
    // Item `it` (and, at it = 0, K and V) has landed, and every warp is
    // done with item it - 1, whose stage the next load refills.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < items) load_item(it + 1, (it + 1) & 1);
    cp_async_commit();

    int h, q0;
    item_rows(it, h, q0);
    // Warp-uniform: keys past Sk, or every key in the rows' future.
    if (kw >= Sk || (causal && kw > q0 + kQRows - 1)) continue;
    const int stage = it & 1;
    const bf16* qt = qs + stage * kTileElems;
    const bf16* ot = dos + stage * kTileElems;

    // s^T = K.Q^T and dp^T = V.dO^T: the warp's 16 keys by the item's rows.
    float st[kQTiles][4], pt[kQTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = pt[nt][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < kDSteps; ++kd) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, k_rows + kd * 32);
      ldsm_x4(av, v_rows + kd * 32);
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        const int off = np * 16 * kStride + kd * 16 + b_plain;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, smem_addr(qt + off));
        ldsm_x4(bo, smem_addr(ot + off));
        mma_bf16(st[2 * np], ak, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(pt[2 * np], av, bo[0], bo[1]);
        mma_bf16(pt[2 * np + 1], av, bo[2], bo[3]);
      }
    }

    // p^T = exp2(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T - D), on
    // the fragments: column (row of the item) nt * 8 + 2c + (e & 1), key
    // kw + g + 8 (e >> 1).  Masked: the causal future and rows past Sq.
    const float* ls = lse_s + stage * kQRows;
    const float* dl = dlt_s + stage * kQRows;
    const bool masked = q0 + kQRows > Sq || (causal && kw + 15 > q0);
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + nt * 8 + 2 * c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + nt * 8 + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l2.y : l2.x) * kLog2e;
        float p = ex2(fmaf(st[nt][e], scale2, -lse2));
        if (masked) {
          const int t = q0 + nt * 8 + 2 * c + (e & 1);
          if (t >= Sq || (causal && kw + g + 8 * (e >> 1) > t)) p = 0.0f;
        }
        st[nt][e] = p;
        pt[nt][e] = p * (pt[nt][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dv += p^T.dO and dk += ds^T.Q: the accumulators of n8 tiles 2kk and
    // 2kk + 1 are the A fragment of k16 step kk; ldmatrix.trans of 16 rows
    // x 16 dims gives the B fragments of two n8 dim tiles.
#pragma unroll
    for (int kk = 0; kk < kQTiles / 2; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 2 * kk + (i >> 1);
        const int e = 2 * (i & 1);
        to_operand<kSplitP>(st[nt][e], st[nt][e + 1], ph[i], pl[i]);
        to_operand<kSplitDs>(pt[nt][e], pt[nt][e + 1], sh[i], sl[i]);
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        const int off = kk * 16 * kStride + dp * 16 + b_trans;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, smem_addr(ot + off));
        ldsm_x4_trans(bq, smem_addr(qt + off));
        mma_bf16(dv_acc[2 * dp], ph, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dp + 1], ph, bo[2], bo[3]);
        mma_bf16(dk_acc[2 * dp], sh, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dp + 1], sh, bq[2], bq[3]);
        if constexpr (kSplitP) {
          mma_bf16(dv_acc[2 * dp], pl, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * dp + 1], pl, bo[2], bo[3]);
        }
        if constexpr (kSplitDs) {
          mma_bf16(dk_acc[2 * dp], sl, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dp + 1], sl, bq[2], bq[3]);
        }
      }
    }
  }

  // Epilogue: every copy into ks/vs has landed (with no item, none was
  // waited for) and from here a warp touches only its own 16 rows: dk
  // scaled, both rounded once, staged there, then 16-byte stores.
  cp_async_wait<0>();
  __syncthreads();
  bf16* kst = ks + 16 * warp * kStride;
  bf16* vst = vs + 16 * warp * kStride;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(kst + g * kStride + col) =
        __floats2bfloat162_rn(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(kst + (g + 8) * kStride + col) =
        __floats2bfloat162_rn(dk_acc[i][2] * scale, dk_acc[i][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(vst + g * kStride + col) =
        __floats2bfloat162_rn(dv_acc[i][0], dv_acc[i][1]);
    *reinterpret_cast<__nv_bfloat162*>(vst + (g + 8) * kStride + col) =
        __floats2bfloat162_rn(dv_acc[i][2], dv_acc[i][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    if (kw + r < Sk) {
      const long long off = kv_off + (kw + r) * kv_stride + ch * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(kst + r * kStride + ch * 8);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(vst + r * kStride + ch * 8);
    }
  }
}

// dq of one block of W warps: (batch * KV head, tile of 16 * W flat rows),
// flat row f being position f / G of query head hk * G + f % G, as in the
// forward's bf16 kernel.  Tile index reversed so the longest causal tiles
// start first.  With kDeltaInDq it also forms and writes its rows' D.
template <int D, int W>
__global__ void __launch_bounds__(W * 32)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ out,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ dlt, bf16* __restrict__ dq, int Sq, int Sk,
                  int Hq, int Hkv, int causal, float scale) {
  constexpr int kBlockRows = 16 * W;
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;
  constexpr int kDSteps = D / 16;          // k16 steps over D (s, dp)
  constexpr int kDTiles = D / 8;           // n8 tiles over D (dq)
  constexpr int kKTiles = kKeyTile / 8;    // n8 tiles over a key tile
  constexpr int kTileElems = kKeyTile * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBlockRows][kStride]
  bf16* dos = qs + kBlockRows * kStride;          // [kBlockRows][kStride]
  bf16* ks = dos + kBlockRows * kStride;          // [2][kKeyTile][kStride]
  bf16* vs = ks + 2 * kTileElems;                 // [2][kKeyTile][kStride]

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
  const float scale2 = scale * kLog2e;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long q_head0 =
      (static_cast<long long>(b) * Sq * Hq + static_cast<long long>(hk) * G) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  auto row_offset = [&](int f) -> long long {
    const int t = f / G;
    return t * q_stride + static_cast<long long>(f - t * G) * D;
  };

  // Group 0: the block's Q and dO rows (zero past Sq * G).
  for (int e = tid; e < kBlockRows * kChunks; e += W * 32) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    const bool in = f0 + r < n_rows;
    const long long off = q_head0 + (in ? row_offset(f0 + r) + ch * 8 : 0);
    cp_async16(smem_addr(qs + r * kStride + ch * 8), q + off, in);
    cp_async16(smem_addr(dos + r * kStride + ch * 8), dout + off, in);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    const int t0 = tile * kKeyTile;
    bf16* kd = ks + stage * kTileElems;
    bf16* vd = vs + stage * kTileElems;
    for (int e = tid; e < kKeyTile * kChunks; e += W * 32) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const bool in = t0 + r < Sk;
      const long long off = kv_off + (in ? (t0 + r) * kv_stride + ch * 8 : 0);
      cp_async16(smem_addr(kd + r * kStride + ch * 8), k + off, in);
      cp_async16(smem_addr(vd + r * kStride + ch * 8), v + off, in);
    }
  };

  // Keys the block needs: causal rows stop at the block's last position.
  const int last_pos = (min(f0 + kBlockRows, n_rows) - 1) / G;
  const int k_end = causal ? min(Sk, last_pos + 1) : Sk;
  const int n_tiles = (k_end + kKeyTile - 1) / kKeyTile;
  // Group 1: the first K/V tile.
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // The warp's flat rows are wf0 + [0, 16); this thread's wf0 + g and
  // wf0 + g + 8, at positions pos[0], pos[1], with their lse (log2 units)
  // and D (0 past Sq * G, where Q and dO are zero; formed below with
  // kDeltaInDq).
  const int wf0 = f0 + 16 * warp;
  const int warp_pos0 = wf0 / G;
  const int pos[2] = {(wf0 + g) / G, (wf0 + g + 8) / G};
  const int warp_k_end =
      wf0 >= n_rows ? 0
      : causal      ? min(Sk, (min(wf0 + 16, n_rows) - 1) / G + 1)
                    : Sk;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = wf0 + g + 8 * i;
    lse2[i] = dl[i] = 0.0f;
    if (f < n_rows) {
      const int t = f / G;
      const long long row =
          (static_cast<long long>(b) * Hq + hk * G + (f - t * G)) * Sq + t;
      lse2[i] = lse[row] * kLog2e;
      if constexpr (!kDeltaInDq) dl[i] = dlt[row];
    }
  }
  const int b_plain = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
  const int b_trans = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;

  uint32_t qf[kDSteps][4], of[kDSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();

    if (it == 0) {
      const int a_off = (16 * warp + (lane & 15)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int kd = 0; kd < kDSteps; ++kd) {
        ldsm_x4(qf[kd], smem_addr(qs + a_off + kd * 16));
        ldsm_x4(of[kd], smem_addr(dos + a_off + kd * 16));
      }
      if constexpr (kDeltaInDq) {
        // D of the warp's 16 rows: lane 2r + h sums half h of row r (O
        // from device memory, dO from the staged rows), a shuffle adds the
        // halves; the rows' owners in the fragment layout take theirs.
        const int f = wf0 + (lane >> 1);
        float d = 0.0f;
        if (f < n_rows) {
          const int half = (lane & 1) * (D / 2);
          const bf16* orow = out + q_head0 + row_offset(f) + half;
          const bf16* grow = dos + (16 * warp + (lane >> 1)) * kStride + half;
#pragma unroll
          for (int j = 0; j < D / 2; j += 8)
            d = dot8(*reinterpret_cast<const uint4*>(orow + j),
                     *reinterpret_cast<const uint4*>(grow + j), d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if ((lane & 1) == 0 && f < n_rows) {
          const int t = f / G;
          dlt[(static_cast<long long>(b) * Hq + hk * G + (f - t * G)) * Sq + t] = d;
        }
        dl[0] = __shfl_sync(0xffffffffu, d, 2 * g);
        dl[1] = __shfl_sync(0xffffffffu, d, 2 * (g + 8));
      }
    }
    const int t0 = it * kKeyTile;
    // Warp-uniform: a diagonal tile may lie wholly in this warp's future.
    if (t0 >= warp_k_end) continue;
    const bf16* kt = ks + (it & 1) * kTileElems;
    const bf16* vt = vs + (it & 1) * kTileElems;
    // Key n8 tiles this warp needs: those starting before warp_k_end.
    const int live = min(kKTiles, (warp_k_end - t0 + 7) / 8);

    // s = Q.K^T and dp = dO.V^T; a second pair of n8 key tiles wholly in
    // the warp's future is skipped.
    float s[kKTiles][4], dp[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < kDSteps; ++kd) {
#pragma unroll
      for (int np = 0; np < kKTiles / 2; ++np) {
        if (2 * np >= live) break;
        const int off = np * 16 * kStride + kd * 16 + b_plain;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, smem_addr(kt + off));
        ldsm_x4(bv, smem_addr(vt + off));
        mma_bf16(s[2 * np], qf[kd], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kd], bk[2], bk[3]);
        mma_bf16(dp[2 * np], of[kd], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], of[kd], bv[2], bv[3]);
      }
    }

    // ds = p (dp - D) with p = exp2(s scale log2 e - lse log2 e): row
    // g + 8 (e >> 1), key t0 + nt * 8 + 2c + (e & 1).  Masked: the causal
    // future, keys past Sk, the key tiles skipped above.
    const bool masked = t0 + kKeyTile > warp_k_end ||
                        (causal && t0 + kKeyTile > warp_pos0 + 1);
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[nt][e], scale2, -lse2[e >> 1]));
        if (masked) {
          const int key = t0 + nt * 8 + 2 * c + (e & 1);
          if (key >= warp_k_end || (causal && key > pos[e >> 1])) p = 0.0f;
        }
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
    }

    // dq += ds.K: the ds accumulators of key tiles 2kk, 2kk + 1 are the A
    // fragment of k16 step kk; K through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kKTiles / 2; ++kk) {
      if (2 * kk >= live) break;
      uint32_t sh[4], sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 2 * kk + (i >> 1);
        const int e = 2 * (i & 1);
        to_operand<kSplitDs>(s[nt][e], s[nt][e + 1], sh[i], sl[i]);
      }
#pragma unroll
      for (int dpair = 0; dpair < kDTiles / 2; ++dpair) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, smem_addr(kt + kk * 16 * kStride + dpair * 16 + b_trans));
        mma_bf16(acc[2 * dpair], sh, bk[0], bk[1]);
        mma_bf16(acc[2 * dpair + 1], sh, bk[2], bk[3]);
        if constexpr (kSplitDs) {
          mma_bf16(acc[2 * dpair], sl, bk[0], bk[1]);
          mma_bf16(acc[2 * dpair + 1], sl, bk[2], bk[3]);
        }
      }
    }
  }

  // Epilogue: dq scaled and rounded once, staged in the warp's own Q rows
  // (no other warp reads them), then 16-byte stores of the rows inside
  // Sq * G.
  bf16* stage = qs + 16 * warp * kStride;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kStride + col) =
        __floats2bfloat162_rn(acc[i][0] * scale, acc[i][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kStride + col) =
        __floats2bfloat162_rn(acc[i][2] * scale, acc[i][3] * scale);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    if (wf0 + r < n_rows)
      *reinterpret_cast<uint4*>(dq + q_head0 + row_offset(wf0 + r) + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// bf16, D in {64, 112, 128}: the Hopper body (wgmma, TMA)
// ---------------------------------------------------------------------------

constexpr int kBwdKeys = 64;    // keys a block: the M tile of s^T, dp^T, dK, dV
constexpr int kBwdRows = 64;    // query rows (positions of one head) an item
constexpr int kBwdStages = 2;   // Q/dO tiles in the TMA ring
// The dK/dV grid's order, chosen per call from the shape
// (`key_tiles_inner`): a KV head's key tiles dispatched together (the
// blocks in flight read few heads' Q and dO, which L2 then holds) unless
// the longest block (G heads x its query tiles) is more than kLongBlock
// times the items an SM's block slots get on average; then every KV
// head's heaviest key tile first, across the card, so the longest start
// first.
constexpr float kLongBlock = 0.5f;
constexpr int kDqKeys = 32;     // keys per K/V tile of the dQ kernel
// The dQ kernel's blockIdx.x walks a KV head's row tiles (so blocks in
// flight share their heads' K and V in L2); false: every KV head's
// heaviest row tile first, as the forward.
constexpr bool kDqTilesInner = true;
constexpr int kDqStages = 2;    // K/V tiles in its TMA ring

template <int D>
__host__ __device__ constexpr int halves() {
  return (D + 63) / 64;
}

template <int D, int BK, int S>
constexpr size_t dq_wgmma_smem_bytes() {
  return 1024 + static_cast<size_t>(halves<D>()) * 128 * (2 * 64 + 2 * S * BK) +
         sizeof(float) * 2 * 64 + 8 * (1 + S);
}

template <int D, int S>
constexpr size_t bwd_wgmma_smem_bytes() {
  return 1024 + static_cast<size_t>(halves<D>()) * 128 * (2 * kBwdKeys + 2 * S * kBwdRows) +
         sizeof(float) * 2 * 2 * kBwdRows               // lse and D, two slots
         + 8 * (1 + S);                                 // mbarriers
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// dq and D of one block of one warpgroup per (batch * KV head, tile of
// P = 64 / G positions), the forward's block shape: its 64 rows are the
// (position, query head) pairs in flat order (rows past R = P G zeros), so
// the G heads share every K/V tile.  Q and dO come once by TMA (5-D boxes,
// as the forward's Q); K and V tiles of BK keys through rings of S stages.
// Per tile: s = Q.K^T and dp = dO.V^T on wgmma (SS), p and ds on the
// fragments, dq += ds.K with ds (rounded once to bf16) as the register A
// operand and K MN-major.  The block first forms D of its rows from O
// (device memory) and dO (its staged tile) and writes it for the dK/dV
// blocks, which run next.  Tile index reversed so the longest causal
// tiles start first.
template <int D, int BK, int S>
__global__ void __launch_bounds__(128)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq, const bf16* __restrict__ out,
                    const float* __restrict__ lse, float* __restrict__ dlt, int Sq, int Sk,
                    int Hq, int Hkv, int causal, float scale) {
  constexpr int kH = halves<D>();
  constexpr int kQHalf = 64 * 128;        // bytes of a 64-row, 64-column half
  constexpr int kKVHalf = BK * 128;       // ... of a K or V tile
  constexpr int kDSteps = D / 16;         // k16 steps of s, dp
  constexpr int kKSteps = BK / 16;        // k16 steps of dq
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);     // [kH][64 rows][128 B]
  unsigned char* dos = qs + kH * kQHalf;        // [kH][64 rows][128 B]
  unsigned char* ks = dos + kH * kQHalf;        // [S][kH][BK keys][128 B]
  unsigned char* vs = ks + S * kH * kKVHalf;    // [S][kH][BK keys][128 B]
  float* row_s = reinterpret_cast<float*>(vs + S * kH * kKVHalf);  // [lse log2 e, D][64]
  // mbarriers: Q and dO, then a K/V stage each.
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_s + 2 * 64);

  const int G = Hq / Hkv;
  const int P = 64 / G;
  const int R = P * G;
  const int bh = kDqTilesInner ? blockIdx.y : blockIdx.x;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int row_tile = kDqTilesInner ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int t0 = row_tile * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int c = tid & 3;
  const int k_end = causal ? min(Sk, min(t0 + P, Sq)) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const float scale2 = scale * kLog2e;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  if (R < 64) {  // rows no box fills: zeros
    const int n = kH * (64 - R) * 8;
    for (int e = tid; e < n; e += 128) {
      const int h = e / ((64 - R) * 8);
      const int rest = e - h * (64 - R) * 8;
      const int off = h * kQHalf + (R + rest / 8) * 128 + (rest % 8) * 16;
      *reinterpret_cast<uint4*>(qs + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dos + off) = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();
  auto load_kv = [&](int tile) {
    const int st = tile % S;
    mbar_expect_tx(&bars[1 + st], 2 * kH * kKVHalf);
    for (int h = 0; h < kH; ++h) {
      tma_load_4d(ks + (st * kH + h) * kKVHalf, &tk, &bars[1 + st], 64 * h, hk, tile * BK, b);
      tma_load_4d(vs + (st * kH + h) * kKVHalf, &tv, &bars[1 + st], 64 * h, hk, tile * BK, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kH * R * 128);
    for (int h = 0; h < kH; ++h) {
      tma_load_5d(qs + h * kQHalf, &tq, &bars[0], 64 * h, 0, hk, t0, b);
      tma_load_5d(dos + h * kQHalf, &tdo, &bars[0], 64 * h, 0, hk, t0, b);
    }
    for (int t = 0; t < S && t < n_tiles; ++t) load_kv(t);
  }

  // D and lse of row r = tid / 2 (position t0 + r / G, head hk G + r % G):
  // each thread of the pair sums half of the row's columns (O from device
  // memory, dO from its staged tile), a shuffle adds the halves.
  {
    const int r = tid >> 1;
    const int half = tid & 1;
    const int pos = t0 + r / G;
    const bool in = r < R && pos < Sq;
    const long long at = (static_cast<long long>(b) * Hq + hk * G + r % G) * Sq + pos;
    constexpr int kChunks = D / 16;  // 8-column chunks a half
    uint4 o[kChunks];
    const bf16* orow =
        out + ((static_cast<long long>(b) * Sq + pos) * Hq + hk * G + r % G) * D + half * D / 2;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      o[i] = in ? *reinterpret_cast<const uint4*>(orow + 8 * i) : make_uint4(0, 0, 0, 0);
    const float l2 = in && half == 1 ? lse[at] * kLog2e : 0.0f;
    mbar_wait(&bars[0], 0);
    float d = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = half * D / 2 + 8 * i;
      d = dot8(o[i], *reinterpret_cast<const uint4*>(dos + (col / 64) * kQHalf +
                                                     sw128_offset(r, col % 64)), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      row_s[64 + r] = d;
      if (in) dlt[at] = d;
    } else {
      row_s[r] = l2;
    }
  }
  __syncthreads();
  // This thread's rows 16 warp + g (+ 8), at positions pos[0], pos[1].
  const int pos[2] = {t0 + (16 * warp + g) / G, t0 + (16 * warp + g + 8) / G};
  const float lse2[2] = {row_s[16 * warp + g], row_s[16 * warp + g + 8]};
  const float dl[2] = {row_s[64 + 16 * warp + g], row_s[64 + 16 * warp + g + 8]};

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % S;
    mbar_wait(&bars[1 + st], (it / S) & 1);
    const unsigned char* kt = ks + st * kH * kKVHalf;
    const unsigned char* vt = vs + st * kH * kKVHalf;
    float s[BK / 2], dp[BK / 2];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int off = (kk / 4) * kQHalf + (kk % 4) * 32;
      const int koff = (kk / 4) * kKVHalf + (kk % 4) * 32;
      wgmma_ss<BK, 0>(s, desc_sw128(qs + off), desc_sw128(kt + koff), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int off = (kk / 4) * kQHalf + (kk % 4) * 32;
      const int koff = (kk / 4) * kKVHalf + (kk % 4) * 32;
      wgmma_ss<BK, 0>(dp, desc_sw128(dos + off), desc_sw128(vt + koff), kk > 0);
    }
    wgmma_commit();

    // p = exp2(s scale log2 e - lse log2 e), ds = p (dp - D): s[4 nt + e] is
    // row 16 warp + g + 8 (e >> 1), key k0 + 8 nt + 2c + (e & 1).  Masked:
    // the causal future and keys past Sk.
    const int k0 = it * BK;
    const bool masked = k0 + BK > k_end || (causal && k0 + BK - 1 > t0);
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float p = ex2(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (key >= Sk || (causal && key > pos[(i >> 1) & 1])) p = 0.0f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[kKSteps][4], unused;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        to_operand<kSplitDs>(s[x] * (dp[x] - dl[(x >> 1) & 1]),
                             s[x + 1] * (dp[x + 1] - dl[(x >> 1) & 1]), da[kk][i], unused);
      }

    // dq += ds.K: K MN-major, a k16 step 16 key rows (2048 bytes) on, N = D.
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_rs<D, 1>(acc, da[kk], desc_sw128(kt + kk * 2048, kKVHalf), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && it + S < n_tiles) load_kv(it + S);
  }

  // Epilogue: dq scaled and rounded once, staged swizzled in the spent Q
  // tile, written by TMA (rows past Sq and columns past D dropped).
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = 8 * nt + 2 * c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(qs + (col / 64) * kQHalf + sw128_offset(r, col % 64)) =
          __floats2bfloat162_rn(acc[4 * nt + 2 * i] * scale, acc[4 * nt + 2 * i + 1] * scale);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int h = 0; h < kH; ++h) tma_store_5d(&tdq, qs + h * kQHalf, 64 * h, 0, hk, t0, b);
    tma_store_drain();
  }
}

// dk, dv of one (batch, KV head, tile of 64 keys): one warpgroup; thread
// 0 issues every TMA copy.  Either grid order (`key_tiles_inner`)
// dispatches a KV head's key tiles in ascending order, first (causal:
// heaviest) first.
template <int D, int S>
__global__ void __launch_bounds__(128)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                 const float* __restrict__ lse, const float* __restrict__ dlt, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale, int key_tiles_inner) {
  constexpr int kH = halves<D>();
  constexpr int kTile = 64 * 128;         // bytes of a 64-row, 64-column half
  constexpr int kDSteps = D / 16;         // k16 steps over D (s^T, dp^T)
  constexpr int kRSteps = kBwdRows / 16;  // k16 steps over an item's rows (dV, dK)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);      // [kH][64 keys][128 B]
  unsigned char* vs = ks + kH * kTile;          // [kH][64 keys][128 B]
  unsigned char* qs = vs + kH * kTile;          // [S][kH][64 rows][128 B]
  unsigned char* dos = qs + S * kH * kTile;     // [S][kH][64 rows][128 B]
  float* row_s = reinterpret_cast<float*>(dos + S * kH * kTile);  // [2][lse, D][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_s + 4 * kBwdRows);  // K/V, then a stage each

  const int G = Hq / Hkv;
  const int j = key_tiles_inner ? blockIdx.x : blockIdx.y;  // key tile
  const int bh = key_tiles_inner ? blockIdx.y : blockIdx.x;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int k0 = j * kBwdKeys;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int c = tid & 3;
  const float scale2 = scale * kLog2e;
  const int n_qt = (Sq + kBwdRows - 1) / kBwdRows;
  // Items (query tile i, head): tiles from the last down to the key
  // tile's first (causal), the G heads inner.
  const int i_lo = causal ? min(j, n_qt) : 0;
  const int items = (n_qt - i_lo) * G;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_item = [&](int item) {
    const int st = item % S;
    const int i = n_qt - 1 - item / G;
    const int h = hk * G + item % G;
    mbar_expect_tx(&bars[1 + st], 2 * kH * kTile);
    for (int x = 0; x < kH; ++x) {
      tma_load_4d(qs + (st * kH + x) * kTile, &tq, &bars[1 + st], 64 * x, h, i * kBwdRows, b);
      tma_load_4d(dos + (st * kH + x) * kTile, &tdo, &bars[1 + st], 64 * x, h, i * kBwdRows, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kH * kTile);
    for (int x = 0; x < kH; ++x) {
      tma_load_4d(ks + x * kTile, &tk, &bars[0], 64 * x, hk, k0, b);
      tma_load_4d(vs + x * kTile, &tv, &bars[0], 64 * x, hk, k0, b);
    }
    for (int t = 0; t < S && t < items; ++t) load_item(t);
  }
  // lse (log2 units) and D of an item's rows, 0 past Sq: thread r < 64
  // holds row r's lse, thread 64 + r its D; staged a slot an item.
  auto row_value = [&](int item) -> float {
    const int r = tid & (kBwdRows - 1);
    const int t = (n_qt - 1 - item / G) * kBwdRows + r;
    if (item >= items || t >= Sq) return 0.0f;
    const long long at =
        (static_cast<long long>(b) * Hq + hk * G + item % G) * Sq + t;
    return tid < kBwdRows ? lse[at] * kLog2e : dlt[at];
  };
  row_s[tid] = row_value(0);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  // This thread's keys in the s^T fragments: k0 + 16 warp + g (+ 8).
  const int key0 = k0 + 16 * warp + g;
  mbar_wait(&bars[0], 0);
  __syncthreads();  // row_s of item 0

  for (int it = 0; it < items; ++it) {
    const int st = it % S;
    const int i = n_qt - 1 - it / G;
    const int h = hk * G + it % G;
    const int q0 = i * kBwdRows;
    const unsigned char* qt = qs + st * kH * kTile;
    const unsigned char* ot = dos + st * kH * kTile;
    mbar_wait(&bars[1 + st], (it / S) & 1);

    // s^T = K.Q^T and dp^T = V.dO^T: the block's 64 keys by the item's
    // 64 rows, every operand K-major in shared memory.
    float st_acc[kBwdRows / 2], dpt[kBwdRows / 2];
    fence_regs(st_acc);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int x = kk / 4;
      const int off = x * kTile + (kk % 4) * 32;
      wgmma_ss<kBwdRows, 0>(st_acc, desc_sw128(ks + off), desc_sw128(qt + off), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      const int x = kk / 4;
      const int off = x * kTile + (kk % 4) * 32;
      wgmma_ss<kBwdRows, 0>(dpt, desc_sw128(vs + off), desc_sw128(ot + off), kk > 0);
    }
    wgmma_commit();
    const float next_row = row_value(it + 1);  // in flight during the products

    // p^T = exp2(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T - D) on
    // the fragments: [4 nt + e] is key key0 + 8 (e >> 1), row q0 + 8 nt +
    // 2c + (e & 1).  Masked: the causal future (rows past Sq have zero Q
    // and dO, keys past Sk zero K and V, and are not stored).
    const float* ls = row_s + (it & 1) * 2 * kBwdRows;
    const float* dl = ls + kBwdRows;
    const bool masked = causal && k0 + 16 * warp + 15 > q0;  // warp-uniform
    wgmma_wait<1>();
    fence_regs(st_acc);
#pragma unroll
    for (int nt = 0; nt < kBwdRows / 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + nt * 8 + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(st_acc[4 * nt + e], scale2, -((e & 1) ? l2.y : l2.x)));
        if (masked && key0 + 8 * (e >> 1) > q0 + nt * 8 + 2 * c + (e & 1)) p = 0.0f;
        st_acc[4 * nt + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int nt = 0; nt < kBwdRows / 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + nt * 8 + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * nt + e] = st_acc[4 * nt + e] * (dpt[4 * nt + e] - ((e & 1) ? d2.y : d2.x));
    }

    // dv += p^T.dO and dk += ds^T.Q: p^T and ds^T rounded once to bf16 are
    // the A fragments (rows of n8 tiles 2kk, 2kk + 1 make k16 step kk);
    // dO and Q MN-major, a k16 step 16 rows (2048 bytes) on, N = D.
    // (Split, the lo parts add a product each.)
    uint32_t pa[kRSteps][4], pl[kRSteps][4], sa[kRSteps][4], sl[kRSteps][4];
#pragma unroll
    for (int kk = 0; kk < kRSteps; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        to_operand<kSplitP>(st_acc[8 * kk + 2 * x], st_acc[8 * kk + 2 * x + 1], pa[kk][x],
                            pl[kk][x]);
        to_operand<kSplitDs>(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1], sa[kk][x],
                             sl[kk][x]);
      }
    fence_regs(pa);
    fence_regs(sa);
    if constexpr (kSplitP) fence_regs(pl);
    if constexpr (kSplitDs) fence_regs(sl);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRSteps; ++kk) {
      const uint64_t d_o = desc_sw128(ot + kk * 2048, kTile);
      const uint64_t d_q = desc_sw128(qt + kk * 2048, kTile);
      wgmma_rs<D, 1>(dv_acc, pa[kk], d_o, 1);
      wgmma_rs<D, 1>(dk_acc, sa[kk], d_q, 1);
      if constexpr (kSplitP) wgmma_rs<D, 1>(dv_acc, pl[kk], d_o, 1);
      if constexpr (kSplitDs) wgmma_rs<D, 1>(dk_acc, sl[kk], d_q, 1);
    }
    wgmma_commit();

    // The next item's row slot: its readers (item it - 1) passed this
    // item's barriers; this item's read before the barrier that follows.
    row_s[((it + 1) & 1) * 2 * kBwdRows + tid] = next_row;
    wgmma_wait<0>();  // dV, dK: their A registers are free
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warp done with stage st
    if (tid == 0 && it + S < items) load_item(it + S);
  }

  // Epilogue: dk scaled, both rounded once, staged swizzled in the K and V
  // tiles (every read of them is done), written by TMA (keys past Sk and
  // columns past D dropped).
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = 8 * nt + 2 * c;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = 16 * warp + g + 8 * x;
      const int off = (col / 64) * kTile + sw128_offset(r, col % 64);
      *reinterpret_cast<__nv_bfloat162*>(ks + off) = __floats2bfloat162_rn(
          dk_acc[4 * nt + 2 * x] * scale, dk_acc[4 * nt + 2 * x + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vs + off) =
          __floats2bfloat162_rn(dv_acc[4 * nt + 2 * x], dv_acc[4 * nt + 2 * x + 1]);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int x = 0; x < kH; ++x) {
      tma_store_4d(&tdk, ks + x * kTile, 64 * x, hk, k0, b);
      tma_store_4d(&tdv, vs + x * kTile, 64 * x, hk, k0, b);
    }
    tma_store_drain();
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D>
int launch_delta(const void* out, const void* dout, float* dlt, int B, int Sq,
                 int Hq, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dlt, Sq, Hq, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* dlt, void* dq, void* dk,
               void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  using T = float;
  constexpr size_t smem = smem_bytes<D>();
  int err = allow_smem(bwd_dkdv_kernel<T, D>, smem);
  if (err == 0) err = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (err == 0) err = launch_delta<T, D>(out, dout, dlt, B, Sq, Hq, stream);
  if (err != 0) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 kv_grid(B * Hkv, (Sk + kTile - 1) / kTile);
  bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dlt, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, Hkv, causal, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 q_grid(B * Hq, (Sq + kTile - 1) / kTile);
  bwd_dq_kernel<T, D><<<q_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dlt, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int W>
int launch_dq_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                  const bf16* dout, const float* lse, float* dlt, bf16* dq, int B,
                  int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
                  cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D, W>();
  const int err = allow_smem(bwd_dq_mma_kernel<D, W>, smem);
  if (err != 0) return err;
  const long long tiles =
      (static_cast<long long>(Sq) * (Hq / Hkv) + 16 * W - 1) / (16 * W);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hkv, static_cast<unsigned>(tiles));
  bwd_dq_mma_kernel<D, W><<<grid, W * 32, smem, stream>>>(
      q, k, v, out, dout, lse, dlt, dq, Sq, Sk, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16_mma(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* dlt, void* dq, void* dk,
                void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  int err = allow_smem(bwd_dkdv_mma_kernel<D>, smem);
  if (err == 0 && !kDeltaInDq) err = launch_delta<bf16, D>(out, dout, dlt, B, Sq, Hq, stream);
  if (err != 0) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(out);
  const bf16* dot = static_cast<const bf16*>(dout);
  // dq first (it writes D with kDeltaInDq): 4 warps of 16 (position,
  // query head) rows a block; 2 where each row is its own position
  // (G = 1), as in the forward.
  err = Hq == Hkv
      ? launch_dq_mma<D, 2>(qt, kt, vt, ot, dot, lse, dlt, static_cast<bf16*>(dq), B, Sq,
                            Sk, Hq, Hkv, causal, scale, stream)
      : launch_dq_mma<D, 4>(qt, kt, vt, ot, dot, lse, dlt, static_cast<bf16*>(dq), B, Sq,
                            Sk, Hq, Hkv, causal, scale, stream);
  if (err != 0) return err;
  const dim3 kv_grid(B * Hkv, (Sk + kKvKeys - 1) / kKvKeys);
  bwd_dkdv_mma_kernel<D><<<kv_grid, kKvWarps * 32, smem, stream>>>(
      qt, kt, vt, dot, lse, dlt, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Sq, Sk, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The six tensor maps of the wgmma body: q, dout as [B][Sq][Hq][D] and k,
// v, dk, dv as [B][Sk][Hkv][D], in boxes of (64 columns, 1 head, 64 rows, 1).
template <int D>
int launch_bf16_wgmma(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const float* lse, float* dlt, void* dq, void* dk,
                      void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                      float scale, cudaStream_t stream) {
  constexpr uint64_t e = sizeof(bf16);
  const uint64_t q_dims[4] = {D, static_cast<uint64_t>(Hq), static_cast<uint64_t>(Sq),
                              static_cast<uint64_t>(B)};
  const uint64_t q_strides[3] = {D * e, Hq * D * e, static_cast<uint64_t>(Sq) * Hq * D * e};
  const uint64_t kv_dims[4] = {D, static_cast<uint64_t>(Hkv), static_cast<uint64_t>(Sk),
                               static_cast<uint64_t>(B)};
  const uint64_t kv_strides[3] = {D * e, Hkv * D * e, static_cast<uint64_t>(Sk) * Hkv * D * e};
  const uint32_t box[4] = {64, 1, 64, 1};
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = make_tensor_map(&tq, q, 4, q_dims, q_strides, box);
  if (err == 0) err = make_tensor_map(&tdo, dout, 4, q_dims, q_strides, box);
  if (err == 0) err = make_tensor_map(&tk, k, 4, kv_dims, kv_strides, box);
  if (err == 0) err = make_tensor_map(&tv, v, 4, kv_dims, kv_strides, box);
  if (err == 0) err = make_tensor_map(&tdk, dk, 4, kv_dims, kv_strides, box);
  if (err == 0) err = make_tensor_map(&tdv, dv, 4, kv_dims, kv_strides, box);
  if (err != 0) return err;
  // dq and D first, by the forward's block shape: q, dout and dq as
  // [B][Sq][Hkv][G][D] in boxes of (64 columns, G heads, 1, P positions,
  // 1), k and v in boxes of kDqKeys keys.
  const int G = Hq / Hkv;
  const int P = 64 / G;
  const long long tiles = (Sq + P - 1) / P;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t r_dims[5] = {D, static_cast<uint64_t>(G), static_cast<uint64_t>(Hkv),
                              static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t r_strides[4] = {D * e, G * D * e, Hq * D * e,
                                 static_cast<uint64_t>(Sq) * Hq * D * e};
  const uint32_t r_box[5] = {64, static_cast<uint32_t>(G), 1, static_cast<uint32_t>(P), 1};
  const uint32_t kv_box[4] = {64, 1, kDqKeys, 1};
  CUtensorMap rq, rdo, rdq, rk, rv;
  err = make_tensor_map(&rq, q, 5, r_dims, r_strides, r_box);
  if (err == 0) err = make_tensor_map(&rdo, dout, 5, r_dims, r_strides, r_box);
  if (err == 0) err = make_tensor_map(&rdq, dq, 5, r_dims, r_strides, r_box);
  if (err == 0) err = make_tensor_map(&rk, k, 4, kv_dims, kv_strides, kv_box);
  if (err == 0) err = make_tensor_map(&rv, v, 4, kv_dims, kv_strides, kv_box);
  if (err != 0) return err;
  constexpr size_t dq_smem = dq_wgmma_smem_bytes<D, kDqKeys, kDqStages>();
  auto dq_kernel = bwd_dq_wgmma_kernel<D, kDqKeys, kDqStages>;
  err = allow_smem(dq_kernel, dq_smem);
  if (err != 0) return err;
  if (kDqTilesInner && B * Hkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 dq_grid = kDqTilesInner ? dim3(static_cast<unsigned>(tiles), B * Hkv)
                                     : dim3(B * Hkv, static_cast<unsigned>(tiles));
  dq_kernel<<<dq_grid, 128, dq_smem, stream>>>(
      rq, rdo, rk, rv, rdq, static_cast<const bf16*>(out), lse, dlt, Sq, Sk, Hq, Hkv, causal,
      scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  constexpr size_t smem = bwd_wgmma_smem_bytes<D, kBwdStages>();
  auto kernel = bwd_wgmma_kernel<D, kBwdStages>;
  err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int n_kt = (Sk + kBwdKeys - 1) / kBwdKeys;
  const int n_qt = (Sq + kBwdRows - 1) / kBwdRows;
  long long items = 0;  // every block's (query tile, head) items
  for (int j = 0; j < n_kt; ++j) items += n_qt - (causal ? min(j, n_qt) : 0);
  items *= static_cast<long long>(B) * Hq;
  int device = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err != 0) return err;
  const double per_slot = static_cast<double>(items) / (2.0 * sms);  // two blocks an SM
  const int inner = static_cast<double>(n_qt) * (Hq / Hkv) <= kLongBlock * per_slot ? 1 : 0;
  if (inner && B * Hkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = inner ? dim3(n_kt, B * Hkv) : dim3(B * Hkv, n_kt);
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, tdo, tdk, tdv, lse, dlt, Sq, Sk, Hq, Hkv,
                                      causal, scale, inner);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* dlt, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
             float scale, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_f32<D>(q, k, v, out, dout, lse, dlt, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, causal, scale, s);
    case 1:
      // The head dims a 128-byte swizzle row serves run on wgmma where a
      // 64-row tile holds a whole position (G <= 64); the rest keep the
      // mma.sync body.
      if constexpr (D >= 64) {
        if (Hq / Hkv <= 64)
          return launch_bf16_wgmma<D>(q, k, v, out, dout, lse, dlt, dq, dk, dv, B, Sq, Sk, Hq,
                                      Hkv, causal, scale, s);
      }
      return launch_bf16_mma<D>(q, k, v, out, dout, lse, dlt, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                                causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out, dout and dq [B, Sq, Hq, D], k, v, dk and dv [B, Sk, Hkv, D], all
// contiguous, of one type (dtype 0: float32, 1: bfloat16) and 16-byte
// aligned; lse (the forward's) and the scratch `dlt` float32 [B, Hq, Sq];
// D in {16, 32, 64, 112, 128}, Hq a multiple of Hkv.  Launches its
// kernels on `stream` (PyTorch's current stream); returns the first
// cudaError_t, 0 when all were queued.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dlt, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, float scale, int dtype,
    int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(dlt);
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 32:
      return launch_d<32>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 64:
      return launch_d<64>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 112:
      return launch_d<112>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 128:
      return launch_d<128>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
