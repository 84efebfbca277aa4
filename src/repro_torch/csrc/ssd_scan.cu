// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_fwd`
// (src/repro/kernels/ssd_scan/ssd_scan.py, `_ssd_kernel`).  For one (batch
// b, head h) the sequence is cut into chunks of Q tokens, walked in order
// with the [P, N] float32 state h carried from chunk to chunk (zero at the
// start).  Within a chunk, with cum the running sum of dA from the chunk's
// start and total = cum[Q - 1]:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//         + exp(cum_i) C_i . h^T
//   h  <- exp(total) h + sum_j exp(total - cum_j) xdt_j^T B_j
//
// xdt [B, S, H, P] and dA [B, S, H] are float32, B and C [B, S, N] float32
// or bfloat16 (one per token, shared by all heads), y [B, S, H, P] float32.
// Given an output hout [B, H, P, N] (float32), the scan also writes the
// state after the last chunk there: the prefill that starts a decode cache
// needs it.
//
// What bounds it: at the main path's shape (mamba2-2.7b, 128 rows x 160
// tokens, H = 80, P = 64, N = 128, one chunk of Q = 160, bf16 B and C)
// reading xdt and writing y in float32 moves 839 MB, 255 us at 3.35 TB/s.
// C . B^T is the same for all 80 heads (4.2e8 flops), and the causal
// products of the scores with xdt are 2.0e10 flops, 6.0e10 as the three
// bf16 products the float32 bar needs: on the tensor cores (989 TFLOP/s)
// that is far under the byte floor, on the CUDA cores (67 TFLOP/s float32)
// it is not.  The per-element work around the products (an accurate expf,
// the mask and the hi + lo split of every score) is what the SM issues.
//
// bf16 B and C, with more than one chunk or the final state asked for: the
// state kernel runs first (`ssd_fwd_state_mma_kernel`, the body of
// ssd_state.cuh that the backward's state pass also runs): one block of 8
// warps per (batch, head, 64 state rows) walks the chunks in order, h <-
// exp(total) h + (w o xdt)^T B as an MMA over 32-token slabs through a
// 3-deep cp.async ring (w o xdt split hi + lo, B exact), and writes the
// state entering each chunk to float32 `states` [B, nc, H, P, N], the
// layout the backward reads (autograd saves it, so the backward runs only
// its reverse direction), and the final state to hout.  Then the chunk
// kernel forms y, adding the carried-state term exp(cum_i) C_i . h_c^T from
// `states` into its own accumulators from the second chunk on, so y is
// written once and never read back.
//
// The chunk kernel at P = 64, N = 64 or 128, Q >= 64 (every model shape the
// port drives): the Hopper body (`ssd_wgmma_kernel`), on wgmma_tiles.cuh.
//
// * One block per (batch, chunk, group of heads) holds every 64-row M tile
//   of its chunk, one consumer warpgroup a tile (T = ceil(Q / 64) <= 4;
//   Q = 160 is 2.5 tiles), and 4 producer warps.
//   The group is sized from the shape so that the grid fills the card in
//   few rounds (phase 13: all 80 heads, 128 blocks; zamba2's 8 rows x 112
//   heads: 7 heads, 128 blocks).  One block an SM.
// * The block's C tiles come in once by TMA (bf16, 128-byte swizzle).  Each
//   head's xdt comes in 32 tokens at a time (a slab, float32, by TMA)
//   through a raw ring; the producer warps split it once into hi =
//   bf16(x) and lo = bf16(x - hi), MN-major under the swizzle, into a
//   second ring, beside the slab's B rows (by TMA) and the head's cum (a
//   warp scan of dA).  So xdt is read from device memory once per (row,
//   chunk, head) and split once per head.
// * Per slab up to its diagonal a warpgroup forms C_m . B_s^T (SS wgmma,
//   bf16 products exact, so only the order of summation differs from the
//   float32 plain version; it is the mma.sync body's, so y at one chunk is
//   bit-equal to it), the scores C_i . B_j exp(cum_i - cum_j) on the
//   fragments (accurate expf per element, all sixteen of a slab taken and
//   the masked ones dropped by a select: e^{cum_i} e^{-cum_j} would
//   overflow, cum reaches -130 in a chunk), splits them into register A
//   operands and accumulates y += hi.hi + hi.lo + lo.hi (RS wgmma) in
//   float32.  One bf16 rounding of either operand misses the float32 bar
//   the kernel is held to (tests/test_torch_ssd_numerics.py); the split
//   meets it.  Up to Q = 192, C . B^T of the next slab runs on the tensor
//   cores while the scores are formed.  C . B^T is formed again for every
//   head: that keeps
//   the block's registers and shared memory to two slabs of it, and the
//   tensor cores have the time.
// * From the second chunk on a head's accumulators start at exp(cum_i) C_m .
//   h_c^T: the producer loads h_c by TMA once per block and head and splits
//   it (kSplitH), C exact (SS wgmma, K = N).
// * y is stored once, from the fragments (float2, whole 32-byte sectors).
//
// Other bf16 shapes: the mma.sync body (`ssd_mma_kernel`), one block of 8
// warps per (batch, chunk, tile of 64 chunk rows, group of up to 16 heads),
// C . B^T once per block on `mma.sync.m16n8k16` into shared memory, the
// block's two halves of 4 warps walking alternate heads through two-stage
// `cp.async` rings of 32-row xdt slabs, split once per half; from the
// second chunk on a head's accumulators start at exp(cum_i) C_i . h_c^T,
// h_c read from `states` in 8-byte pieces and split as it is read.  The
// launcher chooses the body by shape; neither falls back to the other.
//
// float32 B and C: the CUDA-core body (`ssd_scan_kernel`), one block of 256
// threads per (batch, head) walking its chunks with the [P][N + 4] state in
// shared memory (allocated only with more than one chunk or a final state
// to write); each chunk is
// streamed in 32-row tiles, C . B^T is recomputed per head and the products
// are float32 FMA loops.  The tensor cores take float32 only as TF32, which
// would need a three-way split of B and C as well.  Which body runs is fixed
// by the dtype; neither falls back to the other.
//
// Any 1 <= Q <= 256 that divides S, P <= 128 and N <= 256 are accepted.
// Accurate expf, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"
#include "ssd_state.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

using ssd_state::ld_bf16x2;
using ssd_state::ld_f2;
using ssd_state::warp_scan;

// ---------------------------------------------------------------------------
// The CUDA-core body: float32 B/C
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // chunk rows per tile
constexpr int kRowsPerWarp = kTile / kWarps;   // 4
constexpr int kMaxPK = kMaxP / 32;             // output columns per lane
constexpr int kMaxNK = kMaxN / 32;             // state columns per lane
constexpr int kStateRows = 8;                  // state rows per warp per pass

// Row stride (floats) of the B, C and state tiles: N rounded up to 4 (for
// float4 reads), plus 4 so that the 8 lanes of a float4 phase hit distinct
// banks.
__host__ __device__ __forceinline__ int row_stride(int N) {
  return ((N + 3) & ~3) + 4;
}

size_t smem_bytes(int P, int N, int Q, bool state) {
  const size_t ns = row_stride(N);
  return sizeof(float) * ((state ? P * ns : 0)          // state h[p][n]
                          + 2 * kTile * ns              // C_i and B_j rows
                          + kTile * P                   // xdt_j rows
                          + kTile * kTile               // scores
                          + ((Q + 31) & ~31));          // cum
}

// rows [t, t + rows) of a [., N] matrix into dst[kTile][ns] as float32,
// zero past `rows` and past N.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int t,
                                          int rows, int N, int ns) {
  const int n4 = (N + 3) & ~3;
  for (int e = threadIdx.x; e < kTile * n4; e += kThreads) {
    const int r = e / n4;
    const int n = e - r * n4;
    dst[r * ns + n] =
        (r < rows && n < N) ? to_f32(src[static_cast<size_t>(t + r) * N + n]) : 0.0f;
  }
}

// xdt rows [t, t + rows) of head h (row stride H * P) into dst[kTile][P],
// each scaled by scale[r] when given; zero past `rows`.
__device__ __forceinline__ void load_x(float* dst, const float* src, size_t stride,
                                       int t, int rows, int P, const float* scale) {
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int r = e / P;
    const int p = e - r * P;
    float v = 0.0f;
    if (r < rows) {
      v = src[static_cast<size_t>(t + r) * stride + p];
      if (scale != nullptr) v *= scale[r];
    }
    dst[e] = v;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One block of 256 threads per (batch, head), walking the chunks in order.
//
// A chunk does not fit in shared memory at Q = 256 (a float32 [Q, N] tile
// of B or C alone is 128 KB), so it is streamed in 32-row tiles: cum is a
// warp scan of dA over the chunk; for each row tile i, C_i is loaded once,
// and for each tile j <= i the block loads B_j and xdt_j, forms the 32 x 32
// scores (C_i . B_j^T) * exp(cum_i - cum_j) under the causal mask in shared
// memory, and accumulates their product with xdt_j in registers; then adds
// exp(cum_i) C_i . h^T and writes y_i.  After the chunk the state is
// updated; after the last chunk only when `hout` is given, which then
// receives it (the Pallas kernel keeps its state in scratch that dies with
// the grid).  Warp w owns
// tile rows w, w + 8, w + 16, w + 24; lane l owns score column l and output
// columns l + 32k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ hout, int S, int H, int P,
                int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ns = row_stride(N);
  const int n_chunks = S / Q;
  const bool state = n_chunks > 1 || hout != nullptr;
  float* hs = smem;                                  // [P][ns]  carried state
  float* cs = hs + (state ? P * ns : 0);             // [kTile][ns]  C rows of tile i
  float* bs = cs + kTile * ns;                       // [kTile][ns]  B rows of tile j
  float* xs = bs + kTile * ns;                       // [kTile][P]   xdt rows of tile j
  float* ss = xs + kTile * P;                        // [kTile][kTile] scores of (i, j)
  float* cum = ss + kTile * kTile;                   // [round32(Q)]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int n_vec = (N + 3) & ~3;
  const size_t x_stride = static_cast<size_t>(H) * P;     // between tokens
  const float* xb = xdt + (static_cast<size_t>(b) * S * H + h) * P;
  float* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  const float* ab = dA + static_cast<size_t>(b) * S * H + h;
  const T* bb = Bm + static_cast<size_t>(b) * S * N;
  const T* cb = Cm + static_cast<size_t>(b) * S * N;

  if (state)
    for (int e = threadIdx.x; e < P * ns; e += kThreads) hs[e] = 0.0f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the previous chunk is done with cum and the tiles
    for (int i = threadIdx.x; i < Q; i += kThreads)
      cum[i] = ab[static_cast<size_t>(t0 + i) * H];
    __syncthreads();
    if (warp == 0) warp_scan(cum, Q, lane);

    for (int it = 0; it < n_tiles; ++it) {
      const int r0 = it * kTile;
      __syncthreads();  // cum is written; the last tile's readers are done
      load_rows(cs, cb, t0 + r0, min(kTile, Q - r0), N, ns);

      float acc[kRowsPerWarp][kMaxPK];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
        for (int pp = 0; pp < kMaxPK; ++pp) acc[k][pp] = 0.0f;

      for (int jt = 0; jt <= it; ++jt) {
        const int c0 = jt * kTile;
        const int nc = min(kTile, Q - c0);
        if (jt > 0) __syncthreads();  // the last (i, j) is done with bs, xs, ss
        load_rows(bs, bb, t0 + c0, nc, N, ns);
        load_x(xs, xb, x_stride, t0 + c0, nc, P, nullptr);
        __syncthreads();

        // Scores of rows warp + 8k against column `lane`.
        float dot[kRowsPerWarp] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* brow = bs + lane * ns;
        for (int n = 0; n < n_vec; n += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + n);
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k) {
            const float4 cv =
                *reinterpret_cast<const float4*>(cs + (warp + kWarps * k) * ns + n);
            dot[k] = dot4(cv, bv, dot[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const int r = warp + kWarps * k;
          const int rg = r0 + r;
          const int cg = c0 + lane;
          float sv = 0.0f;
          if (rg < Q && lane < nc && rg >= cg) sv = dot[k] * expf(cum[rg] - cum[cg]);
          ss[r * kTile + lane] = sv;
        }
        __syncthreads();

        // acc += scores . xdt_j (rows past nc hold zeros on both sides).
        const int nc4 = (nc + 3) & ~3;
        for (int c = 0; c < nc4; c += 4) {
          float4 sv[kRowsPerWarp];
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k)
            sv[k] = *reinterpret_cast<const float4*>(ss + (warp + kWarps * k) * kTile + c);
#pragma unroll
          for (int pp = 0; pp < kMaxPK; ++pp) {
            const int p = lane + 32 * pp;
            if (p < P) {
              const float4 xv = make_float4(xs[c * P + p], xs[(c + 1) * P + p],
                                            xs[(c + 2) * P + p], xs[(c + 3) * P + p]);
#pragma unroll
              for (int k = 0; k < kRowsPerWarp; ++k) acc[k][pp] = dot4(sv[k], xv, acc[k][pp]);
            }
          }
        }
      }

      // The state term C_i . h^T (the state is zero in the first chunk).
      float inter[kRowsPerWarp][kMaxPK];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
        for (int pp = 0; pp < kMaxPK; ++pp) inter[k][pp] = 0.0f;
      if (ci > 0) {
        for (int n = 0; n < n_vec; n += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k)
            cv[k] = *reinterpret_cast<const float4*>(cs + (warp + kWarps * k) * ns + n);
#pragma unroll
          for (int pp = 0; pp < kMaxPK; ++pp) {
            const int p = lane + 32 * pp;
            if (p < P) {
              const float4 hv = *reinterpret_cast<const float4*>(hs + p * ns + n);
#pragma unroll
              for (int k = 0; k < kRowsPerWarp; ++k)
                inter[k][pp] = dot4(cv[k], hv, inter[k][pp]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int rg = r0 + warp + kWarps * k;
        if (rg >= Q) continue;
        const float e = expf(cum[rg]);
        float* yrow = yb + static_cast<size_t>(t0 + rg) * x_stride;
#pragma unroll
        for (int pp = 0; pp < kMaxPK; ++pp) {
          const int p = lane + 32 * pp;
          if (p < P) yrow[p] = acc[k][pp] + inter[k][pp] * e;
        }
      }
    }

    const bool last = ci == n_chunks - 1;
    if (last && hout == nullptr) break;  // nothing reads the last chunk's state

    // h <- exp(total) h + sum_j (exp(total - cum_j) xdt_j)^T B_j, in passes
    // of kWarps * kStateRows state rows; lane l owns columns l + 32k.
    float* w_end = ss;  // the scores tile is free here: kTile weights
    __syncthreads();    // cum is scanned
    const float total = cum[Q - 1];
    const float keep = expf(total);
    for (int p0 = 0; p0 < P; p0 += kWarps * kStateRows) {
      float sacc[kStateRows][kMaxNK];
#pragma unroll
      for (int m = 0; m < kStateRows; ++m)
#pragma unroll
        for (int kn = 0; kn < kMaxNK; ++kn) sacc[m][kn] = 0.0f;
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int c0 = jt * kTile;
        const int nc = min(kTile, Q - c0);
        __syncthreads();  // the last readers of bs, xs and ss are done
        if (threadIdx.x < nc) w_end[threadIdx.x] = expf(total - cum[c0 + threadIdx.x]);
        load_rows(bs, bb, t0 + c0, nc, N, ns);
        __syncthreads();
        load_x(xs, xb, x_stride, t0 + c0, nc, P, w_end);
        __syncthreads();
        for (int c = 0; c < nc; ++c) {
          float xv[kStateRows];
#pragma unroll
          for (int m = 0; m < kStateRows; ++m) {
            const int p = p0 + warp + kWarps * m;
            xv[m] = p < P ? xs[c * P + p] : 0.0f;
          }
#pragma unroll
          for (int kn = 0; kn < kMaxNK; ++kn) {
            const int n = lane + 32 * kn;
            if (n < N) {
              const float bv = bs[c * ns + n];
#pragma unroll
              for (int m = 0; m < kStateRows; ++m) sacc[m][kn] = fmaf(xv[m], bv, sacc[m][kn]);
            }
          }
        }
      }
      // Each state entry has one owner: no other thread reads it until the
      // next chunk's barriers.
#pragma unroll
      for (int m = 0; m < kStateRows; ++m) {
        const int p = p0 + warp + kWarps * m;
        if (p >= P) continue;
#pragma unroll
        for (int kn = 0; kn < kMaxNK; ++kn) {
          const int n = lane + 32 * kn;
          if (n >= N) continue;
          const float hn = hs[p * ns + n] * keep + sacc[m][kn];
          hs[p * ns + n] = hn;
          if (last) hout[(static_cast<size_t>(blockIdx.x) * P + p) * N + n] = hn;
        }
      }
    }
  }
}

template <typename T>
int launch_scan(const float* xdt, const float* dA, const void* Bm, const void* Cm,
                float* y, float* hout, int B, int S, int H, int P, int N, int Q,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q, S / Q > 1 || hout != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      xdt, dA, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, hout, S, H,
      P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 B/C at the shapes the Hopper body does not take: the mma.sync body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kRowWarps = 4;                       // warps across a tile's rows
constexpr int kHalves = 2;                          // warp sets walking alternate heads
constexpr int kMmaWarps = kRowWarps * kHalves;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kHalfThreads = 32 * kRowWarps;
constexpr int kRows = 16 * kRowWarps;   // chunk rows per block
constexpr int kSlab = 32;               // chunk columns per B slab / xdt stage
constexpr int kMaxGroup = 16;           // heads per block
// The state h_c in the carried-state term exp(cum_i) C_i . h_c^T: split hi
// + lo (one bf16 rounding of it misses SSD_TOL,
// tests/test_torch_ssd_numerics.py, which reads this).
constexpr bool kSplitH = true;

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of the tensor-core body.  `ldc` = Q rounded to 16,
// plus 8: the float2 fragment reads of 4 rows then hit distinct banks.
struct MmaShape {
  int np;      // N rounded up to 16
  int ldc;     // row stride (floats) of the C . B^T tile
  int cum_ld;  // row stride (floats) of each head's cum
};

__host__ __device__ __forceinline__ MmaShape mma_shape(int N, int Q) {
  return {round_up(N, 16), round_up(Q, 16) + 8, round_up(Q, 32)};
}

// Bytes of one half's xdt ring (two float32 stages) and split (hi, lo).
template <int PT>
__host__ __device__ constexpr int half_bytes() {
  return sizeof(float) * 2 * kSlab * (16 * PT + 4) + sizeof(bf16) * 2 * kSlab * (16 * PT + 8);
}

template <int PT>
size_t mma_smem_bytes(int N, int Q, int group) {
  const MmaShape sh = mma_shape(N, Q);
  const size_t prologue = sizeof(bf16) * (kRows + kSlab) * (sh.np + 8);
  const size_t heads = static_cast<size_t>(kHalves) * half_bytes<PT>();
  return sizeof(float) * (static_cast<size_t>(kRows) * sh.ldc + group * sh.cum_ld) +
         (prologue > heads ? prologue : heads);
}

// Barrier of one half's kHalfThreads threads: ids 1 and 2 (0 is
// __syncthreads); constant ids, so that ptxas reserves three barriers.
__device__ __forceinline__ void half_sync(int half) {
  static_assert(kHalves <= 2, "one named barrier per half");
  if (half == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kHalfThreads) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(kHalfThreads) : "memory");
}

using mma_tiles::cp_async16;
using mma_tiles::cp_async_commit;
using mma_tiles::cp_async_wait;
using mma_tiles::ldsm_x4;
using mma_tiles::ldsm_x4_trans;
using mma_tiles::mma_bf16;
using mma_tiles::smem_addr;
using mma_tiles::split_bf16;

// Two adjacent float32 outputs of one y row: a float2 store where P is even.
__device__ __forceinline__ void store2(float* dst, float v0, float v1, int p, int P,
                                       bool vec) {
  if (vec && p + 1 < P) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (p < P) dst[0] = v0;
    if (p + 1 < P) dst[1] = v1;
  }
}

// rows [r_begin, r_begin + rows) of a chunk's [Q, N] bf16 matrix `src` into
// dst[rows][np + 8]; zero at rows >= valid and columns >= N.  16-byte
// cp.async where N % 8 == 0 and the rows are 16-byte aligned (`vec`).
__device__ __forceinline__ void load_bc(bf16* dst, const bf16* src, int r_begin, int rows,
                                        int valid, int N, int np, bool vec) {
  const int chunks = np / 8;
  const int ld = np + 8;
  for (int e = threadIdx.x; e < rows * chunks; e += kMmaThreads) {
    const int r = e / chunks;
    const int n = (e - r * chunks) * 8;
    const int row = r_begin + r;
    bf16* d = dst + r * ld + n;
    if (vec) {
      const bool in = row < valid && n < N;
      cp_async16(smem_addr(d), in ? src + static_cast<size_t>(row) * N + n : src, in);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = (row < valid && n + k < N) ? src[static_cast<size_t>(row) * N + n + k]
                                          : __float2bfloat16(0.0f);
    }
  }
}

// acc[nt] += rows r and r + 8 of C . h^T (this thread's rows g and g + 8
// of a 16-row tile), columns p_begin + 8 nt + [0, 8) of P: c_a and c_b
// the two rows of C (bf16, length N, zero where !ok), h [P, N] float32 in
// global memory (row stride N).  C exact, h split hi + lo as it is read
// (two products per k16 step and n8 tile), or rounded once when !kSplit.
template <int NT, bool kSplit>
__device__ __forceinline__ void state_term(float (&acc)[NT][4], const bf16* c_a,
                                           const bf16* c_b, bool ok_a, bool ok_b,
                                           const float* h, int p_begin, int P, int N,
                                           int lane) {
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 16) {
    const uint32_t a[4] = {ld_bf16x2(c_a, k0 + c2, N, ok_a), ld_bf16x2(c_b, k0 + c2, N, ok_b),
                           ld_bf16x2(c_a, k0 + c2 + 8, N, ok_a),
                           ld_bf16x2(c_b, k0 + c2 + 8, N, ok_b)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = p_begin + 8 * nt + g;   // the B fragment's column n = g
      const float* row = h + static_cast<size_t>(p) * N;
      const float2 v0 = ld_f2(row, k0 + c2, N, p < P);
      const float2 v1 = ld_f2(row, k0 + c2 + 8, N, p < P);
      uint32_t h0, l0, h1, l1;
      split_bf16(v0.x, v0.y, h0, l0);
      split_bf16(v1.x, v1.y, h1, l1);
      mma_bf16(acc[nt], a, h0, h1);
      if (kSplit) mma_bf16(acc[nt], a, l0, l1);
    }
  }
}

// One block of kMmaWarps warps per (batch, chunk, tile of kRows chunk rows,
// group of `group` heads).  Warp w owns tile rows [16 r, 16 r + 16), r = w %
// kRowWarps; the block's warps form C . B^T together, then its kHalves
// halves walk alternate heads independently, each with its own xdt ring and
// barrier.  Fragment coordinates (PTX m16n8k16): lane = 4 * g + c; a thread holds
// rows g and g + 8 of every 16 x 8 accumulator, columns 2c and 2c + 1.
// kInter (more than one chunk): from the second chunk on, a head's
// accumulators start at exp(cum_i) C_i . h^T, h the state entering the
// chunk in `states` [B, nc, H, P, N] (the state kernel's), C exact and h
// split hi + lo (kSplitH) as it is read from global memory.
template <int PT, bool kInter>
__global__ void __launch_bounds__(kMmaThreads, PT <= 4 ? 2 : 1)
ssd_mma_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const float* __restrict__ states, float* __restrict__ y, int S, int H, int P,
               int N, int Q, int group, int vec_x, int vec_bc) {
  constexpr int kPp = 16 * PT;   // P padded to the mma tiles
  constexpr int kXs = kPp + 4;   // floats per staged xdt row
  constexpr int kXb = kPp + 8;   // bf16 per hi / lo row: ldmatrix rows on distinct banks
  const MmaShape sh = mma_shape(N, Q);
  const int ld_bc = sh.np + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cbs = reinterpret_cast<float*>(smem_raw);   // [kRows][ldc] C . B^T
  float* cum = cbs + kRows * sh.ldc;                 // [group][cum_ld]
  unsigned char* u = reinterpret_cast<unsigned char*>(cum + group * sh.cum_ld);
  // Before the head loop: the C tile and one slab of B.
  bf16* cs = reinterpret_cast<bf16*>(u);             // [kRows][ld_bc]
  bf16* bs = cs + kRows * ld_bc;                     // [kSlab][ld_bc]

  const int n_tiles = (Q + kRows - 1) / kRows;
  const int n_groups = (H + group - 1) / group;
  const int n_chunks = S / Q;
  int idx = blockIdx.x;
  const int tile = n_tiles - 1 - idx % n_tiles;      // heaviest first
  idx /= n_tiles;
  const int h0 = (idx % n_groups) * group;
  idx /= n_groups;
  const int chunk = idx % n_chunks;
  const int b = idx / n_chunks;

  const int r0 = tile * kRows;
  const int gh = min(group, H - h0);                 // heads of this block
  const int cols = min(Q, r0 + kRows);               // chunk columns it reads
  const int n_slabs = (cols + kSlab - 1) / kSlab;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % kRowWarps;                   // row warp
  const int half = warp / kRowWarps;
  const int htid = tid % kHalfThreads;               // thread within the half
  const int g = lane >> 2;
  const int c = lane & 3;
  const int i0 = r0 + 16 * rw;                       // the warp's first chunk row
  const bool live = i0 < Q;
  const size_t tok0 = static_cast<size_t>(b) * S + static_cast<size_t>(chunk) * Q;
  const size_t x_tok = static_cast<size_t>(H) * P;   // floats between tokens

  // C . B^T for rows [r0, r0 + kRows) and columns [0, cols): C once, B in
  // slabs of kSlab rows; the halves share each slab's 16-column pairs, and
  // each warp forms the 16 x 16 tiles up to its diagonal.
  const bf16* c_src = Cm + tok0 * N;
  const bf16* b_src = Bm + tok0 * N;
  load_bc(cs, c_src, r0, kRows, Q, N, sh.np, vec_bc);
  load_bc(bs, b_src, 0, kSlab, cols, N, sh.np, vec_bc);
  cp_async_commit();
  for (int e = tid; e < cols * gh; e += kMmaThreads) {
    const int j = e / gh;
    const int hh = e - j * gh;
    cum[hh * sh.cum_ld + j] = dA[(tok0 + j) * H + h0 + hh];
  }
  __syncthreads();
  for (int hh = warp; hh < gh; hh += kMmaWarps) warp_scan(cum + hh * sh.cum_ld, cols, lane);

  for (int s = 0; s < n_slabs; ++s) {
    if (s > 0) {
      __syncthreads();  // every warp is done with the last slab
      load_bc(bs, b_src, s * kSlab, kSlab, cols, N, sh.np, vec_bc);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int pair = half; pair < kSlab / 16; pair += kHalves) {
      const int j0 = s * kSlab + 16 * pair;
      if (j0 > i0) break;  // above the warp's diagonal tile
      float acc0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kd = 0; kd < sh.np / 16; ++kd) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, smem_addr(cs + (16 * rw + (lane & 15)) * ld_bc + kd * 16 +
                             (lane >> 4) * 8));
        ldsm_x4(bk, smem_addr(bs + (16 * pair + (lane & 7) + (lane >> 4) * 8) * ld_bc +
                              kd * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(acc0, a, bk[0], bk[1]);
        mma_bf16(acc1, a, bk[2], bk[3]);
      }
      float* ra = cbs + (16 * rw + g) * sh.ldc + j0 + 2 * c;
      float* rb = ra + 8 * sh.ldc;
      *reinterpret_cast<float2*>(ra) = make_float2(acc0[0], acc0[1]);
      *reinterpret_cast<float2*>(rb) = make_float2(acc0[2], acc0[3]);
      *reinterpret_cast<float2*>(ra + 8) = make_float2(acc1[0], acc1[1]);
      *reinterpret_cast<float2*>(rb + 8) = make_float2(acc1[2], acc1[3]);
    }
  }

  // Each half walks heads half, half + kHalves, ... one after another:
  // items (head, slab) in order through its two-stage ring of xdt slabs,
  // which runs on across heads.
  float* xs = reinterpret_cast<float*>(u + half * half_bytes<PT>());  // [2][kSlab][kXs]
  bf16* xh = reinterpret_cast<bf16*>(xs + 2 * kSlab * kXs);          // [kSlab][kXb]
  bf16* xl = xh + kSlab * kXb;                                        // [kSlab][kXb]
  auto issue_x = [&](int item, int stage) {
    const int hh = half + kHalves * (item / n_slabs);
    const int s = item % n_slabs;
    const float* src = xdt + tok0 * x_tok + static_cast<size_t>(h0 + hh) * P;
    float* dst = xs + stage * kSlab * kXs;
    constexpr int kChunks = kPp / 4;
    for (int e = htid; e < kSlab * kChunks; e += kHalfThreads) {
      const int r = e / kChunks;
      const int p = (e - r * kChunks) * 4;
      const int j = s * kSlab + r;
      float* d = dst + r * kXs + p;
      if (vec_x) {
        const bool in = j < cols && p < P;
        cp_async16(smem_addr(d), in ? src + j * x_tok + p : src, in);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          d[k] = (j < cols && p + k < P) ? src[j * x_tok + p + k] : 0.0f;
      }
    }
  };

  float acc[2 * PT][4];
  float cum_a = 0.0f, cum_b = 0.0f;   // cum of this thread's rows i0 + g, i0 + g + 8
  const int ia = i0 + g;
  const int ib = ia + 8;
  const bool vec_y = (P & 1) == 0;
  const int items = (gh - half + kHalves - 1) / kHalves * n_slabs;
  __syncthreads();  // C . B^T is complete; the C tile and B slab are spent
  if (items > 0) issue_x(0, 0);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const int hh = half + kHalves * (it / n_slabs);
    const int s = it % n_slabs;
    cp_async_wait<0>();
    // Stage it & 1 is in; every warp of the half is done with the last split.
    half_sync(half);
    if (it + 1 < items) issue_x(it + 1, (it + 1) & 1);
    cp_async_commit();
    {
      const float* src = xs + (it & 1) * kSlab * kXs;
      constexpr int kChunks = kPp / 4;
      for (int e = htid; e < kSlab * kChunks; e += kHalfThreads) {
        const int r = e / kChunks;
        const int p = (e - r * kChunks) * 4;
        const float4 v = *reinterpret_cast<const float4*>(src + r * kXs + p);
        uint32_t h01, l01, h23, l23;
        split_bf16(v.x, v.y, h01, l01);
        split_bf16(v.z, v.w, h23, l23);
        *reinterpret_cast<uint2*>(xh + r * kXb + p) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(xl + r * kXb + p) = make_uint2(l01, l23);
      }
    }
    half_sync(half);
    if (!live) continue;
    const float* ch = cum + hh * sh.cum_ld;
    if (s == 0) {
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      cum_a = ch[ia];
      cum_b = ch[ib];
      if (kInter && chunk > 0) {
        const bf16* c_a = Cm + (tok0 + ia) * N;
        state_term<2 * PT, kSplitH>(
            acc, c_a, c_a + 8 * N, ia < Q, ib < Q,
            states + ((static_cast<size_t>(b) * n_chunks + chunk) * H + h0 + hh) * P * N, 0, P,
            N, lane);
        const float ea = expf(cum_a);
        const float eb = expf(cum_b);
#pragma unroll
        for (int nt = 0; nt < 2 * PT; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
    }
    // The k16 steps of this slab up to the warp's diagonal tile: all their
    // scores first (independent expf chains), then their products.
    auto step = [&](auto steps) {
      constexpr int kSteps = decltype(steps)::value;
      uint32_t sh_[kSteps][4], sl_[kSteps][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int ja = s * kSlab + 16 * kk + 2 * c;
        const int jb = ja + 8;
        const float* ra = cbs + (ia - r0) * sh.ldc + ja;
        const float* rb = ra + 8 * sh.ldc;
        const float2 cb[4] = {*reinterpret_cast<const float2*>(ra),
                              *reinterpret_cast<const float2*>(rb),
                              *reinterpret_cast<const float2*>(ra + 8),
                              *reinterpret_cast<const float2*>(rb + 8)};
        const float2 cja = *reinterpret_cast<const float2*>(ch + ja);
        const float2 cjb = *reinterpret_cast<const float2*>(ch + jb);
        // A fragment order: (ia, ja), (ib, ja), (ia, jb), (ib, jb).
        const int ri[4] = {ia, ib, ia, ib};
        const int cj[4] = {ja, ja, jb, jb};
        const float ci[4] = {cum_a, cum_b, cum_a, cum_b};
        const float2 cumj[4] = {cja, cja, cjb, cjb};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = ri[q] < Q;
          const float s0 = (in && cj[q] <= ri[q]) ? cb[q].x * expf(ci[q] - cumj[q].x) : 0.0f;
          const float s1 =
              (in && cj[q] + 1 <= ri[q]) ? cb[q].y * expf(ci[q] - cumj[q].y) : 0.0f;
          split_bf16(s0, s1, sh_[kk][q], sl_[kk][q]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int kr = 16 * kk;  // stage row of this k16 step
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          uint32_t bh[4], bl[4];
          const int off = (kr + (lane & 7) + ((lane >> 3) & 1) * 8) * kXb + dp * 16 +
                          (lane >> 4) * 8;
          ldsm_x4_trans(bh, smem_addr(xh + off));
          ldsm_x4_trans(bl, smem_addr(xl + off));
          mma_bf16(acc[2 * dp], sh_[kk], bh[0], bh[1]);
          mma_bf16(acc[2 * dp + 1], sh_[kk], bh[2], bh[3]);
          mma_bf16(acc[2 * dp], sh_[kk], bl[0], bl[1]);
          mma_bf16(acc[2 * dp + 1], sh_[kk], bl[2], bl[3]);
          mma_bf16(acc[2 * dp], sl_[kk], bh[0], bh[1]);
          mma_bf16(acc[2 * dp + 1], sl_[kk], bh[2], bh[3]);
        }
      }
    };
    static_assert(kSlab == 32, "two k16 steps per slab");
    if (s * kSlab + 16 <= i0)
      step(std::integral_constant<int, 2>{});
    else if (s * kSlab <= i0)
      step(std::integral_constant<int, 1>{});
    if (s == n_slabs - 1) {
      float* yh = y + tok0 * x_tok + static_cast<size_t>(h0 + hh) * P;
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) {
        const int p = nt * 8 + 2 * c;
        if (ia < Q) store2(yh + ia * x_tok + p, acc[nt][0], acc[nt][1], p, P, vec_y);
        if (ib < Q) store2(yh + ib * x_tok + p, acc[nt][2], acc[nt][3], p, P, vec_y);
      }
    }
  }
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    counts[device] = 132;
  return counts[device];
}

// Heads per block of the tensor-core body: the largest of 16, 8, 4, 2 that
// still gives at least four blocks per SM, else 1.  More heads per block
// share C . B^T more widely; more blocks fill the card.
int heads_per_block(int B, int S, int H, int Q, int device) {
  const long long tiles = static_cast<long long>(B) * (S / Q) * ((Q + kRows - 1) / kRows);
  const long long target = 4LL * sm_count(device);
  for (int group = kMaxGroup; group > 1; group >>= 1)
    if (group <= H && tiles * ((H + group - 1) / group) >= target) return group;
  return 1;
}

template <int PT, bool kInter>
int launch_mma_pt(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm,
                  const float* states, float* y, int B, int S, int H, int P, int N, int Q,
                  int group, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<PT>(N, Q, group);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<PT, kInter>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // Two blocks of 106 KB per SM at the main path's shape need the
    // largest shared-memory carveout.
    err = cudaFuncSetAttribute(ssd_mma_kernel<PT, kInter>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(B) * (S / Q) *
                           ((H + group - 1) / group) * ((Q + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  ssd_mma_kernel<PT, kInter><<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      xdt, dA, Bm, Cm, states, y, S, H, P, N, Q, group, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInter>
int launch_mma(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm,
               const float* states, float* y, int B, int S, int H, int P, int N, int Q,
               int device, cudaStream_t stream) {
  const int group = heads_per_block(B, S, H, Q, device);
  if (P <= 16)
    return launch_mma_pt<1, kInter>(xdt, dA, Bm, Cm, states, y, B, S, H, P, N, Q, group, stream);
  if (P <= 32)
    return launch_mma_pt<2, kInter>(xdt, dA, Bm, Cm, states, y, B, S, H, P, N, Q, group, stream);
  if (P <= 64)
    return launch_mma_pt<4, kInter>(xdt, dA, Bm, Cm, states, y, B, S, H, P, N, Q, group, stream);
  return launch_mma_pt<8, kInter>(xdt, dA, Bm, Cm, states, y, B, S, H, P, N, Q, group, stream);
}

// The forward direction of ssd_state.cuh's state body: one block of 8
// warps per (batch, head, 64 state rows) writes the state entering each
// chunk c = 1 .. nc - 1 into hs [B, nc, H, P, N], and the state after the
// last chunk into hout when given.
template <int NPW>
__global__ void __launch_bounds__(ssd_state::kStThreads, 1)
ssd_fwd_state_mma_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                         const bf16* __restrict__ Bm, float* __restrict__ hs,
                         float* __restrict__ hout, int S, int H, int P, int N, int Q, int vec_bc,
                         int vec_u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ssd_state::state_pass<NPW>(smem_raw, xdt, dA, Bm, nullptr, nullptr, hs, nullptr, hout, false,
                             S, H, P, N, Q, vec_bc, vec_u);
}

int launch_state(const float* xdt, const float* dA, const bf16* Bm, float* hs, float* hout,
                 int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H * ((P + 63) / 64);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0;
  const int vec_u = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  return static_cast<int>(ssd_state::with_npw(N, [&](auto npw) {
    constexpr int NPW = decltype(npw)::value;
    const size_t smem = ssd_state::state_smem_bytes(N, Q);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(ssd_fwd_state_mma_kernel<NPW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    ssd_fwd_state_mma_kernel<NPW>
        <<<static_cast<unsigned>(blocks), ssd_state::kStThreads, smem, stream>>>(
            xdt, dA, Bm, hs, hout, S, H, P, N, Q, vec_bc, vec_u);
    return cudaGetLastError();
  }));
}

// ---------------------------------------------------------------------------
// bf16 B/C, P = 64, N = 64 or 128, Q >= 64: the Hopper body (wgmma, TMA)
// ---------------------------------------------------------------------------

using wgmma_tiles::desc_sw128;
using wgmma_tiles::fence_async_smem;
using wgmma_tiles::fence_regs;
using wgmma_tiles::mbar_arrive;
using wgmma_tiles::mbar_expect_tx;
using wgmma_tiles::mbar_fence_init;
using wgmma_tiles::mbar_init;
using wgmma_tiles::mbar_wait;
using wgmma_tiles::sw128_offset;
using wgmma_tiles::tma_load_2d;
using wgmma_tiles::tma_load_3d;
using wgmma_tiles::wgmma_commit;
using wgmma_tiles::wgmma_fence;
using wgmma_tiles::wgmma_rs;
using wgmma_tiles::wgmma_ss;
using wgmma_tiles::wgmma_wait;

// The launcher runs the Hopper body at every shape it fits (false: the
// mma.sync body at every bf16 shape, which launch/ssd_fwd_sweep.py times).
constexpr bool kWgmmaBody = true;
constexpr int kWgP = 64;                         // P: one 128-byte swizzle row of bf16
constexpr int kWgSlab = 32;                      // tokens a ring item
constexpr int kRawStages = 4;                    // float32 xdt slabs as TMA lands them
constexpr int kCvStages = 3;                     // split xdt and B slabs as the products read them
// Blocks are built for at most kTiles 64-row tiles (3: Q <= 192, 4: Q <=
// 256) beside 4 producer warps, which split xdt and h_c and issue the
// copies: 512 threads and 128 registers a thread, or 640 and 96 (each
// SM sub-partition's 16K registers go to the four or five warps on it).  With
// 128, a warpgroup forms the next slab's C . B^T while it forms this
// slab's scores (two score sets); with 96, one set, after the scores (the
// second set would spill).
constexpr int kProducerWarps = 4;
template <int kTiles>
__host__ __device__ constexpr int wg_threads() {
  return 128 * kTiles + 32 * kProducerWarps;
}
constexpr int kRegion = 64 * 128;                // a 64-row, 64-column bf16 tile
constexpr int kSlabRegion = kWgSlab * 128;       // a 32-row one
constexpr int kRawX = kWgSlab * kWgP * 4;        // a float32 xdt slab

__host__ __device__ __forceinline__ int cv_stage_bytes(int nr) {
  return (2 + nr) * kSlabRegion;                 // xdt hi, lo, B
}

// Byte offsets of the Hopper body's shared memory, 1024-aligned: the
// block's C tiles, the raw and split rings, the state h_c (float32) and
// its split, two heads' cum, the mbarriers; `bytes` with the base's
// alignment.
struct WgSmem {
  int c, raw, cv, h_raw, h_split, cum, bars, bytes;
};

__host__ __device__ __forceinline__ WgSmem wg_smem(int tiles, int nr, bool term) {
  WgSmem s;
  s.c = 0;
  s.raw = s.c + tiles * nr * kRegion;
  s.cv = s.raw + kRawStages * kRawX;
  s.h_raw = s.cv + kCvStages * cv_stage_bytes(nr);
  s.h_split = s.h_raw + (term ? kWgP * 64 * nr * 4 : 0);
  s.cum = s.h_split + (term ? 2 * nr * kRegion : 0);
  s.bars = s.cum + 2 * kMaxChunk * 4;
  s.bytes = s.bars + 32 * 8 + 1024;
  return s;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// Four float32 values split into hi and lo bf16 at elements (row, col ..
// col + 3) of two 128-byte-swizzled tiles, 64 columns a kRegion.
__device__ __forceinline__ void split_store(unsigned char* hi, unsigned char* lo, float4 v,
                                            int row, int col) {
  uint32_t h01, l01, h23, l23;
  split_bf16(v.x, v.y, h01, l01);
  split_bf16(v.z, v.w, h23, l23);
  const int off = (col >> 6) * kRegion + sw128_offset(row, col & 63);
  *reinterpret_cast<uint2*>(hi + off) = make_uint2(h01, h23);
  *reinterpret_cast<uint2*>(lo + off) = make_uint2(l01, l23);
}

// One block per (batch, chunk, group of `group` heads).  Warpgroup m < T =
// ceil(Q / 64) owns chunk rows [64 m, 64 m + 64), one wgmma M tile; the
// warps after the last warpgroup produce.  Per head, items of 32 tokens
// (slabs) pass through two rings: TMA lands the float32 xdt slab in a raw
// stage, which the producer warps split into hi + lo (MN-major under the
// 128-byte swizzle) in a split stage, beside the slab's B rows (TMA) and
// the head's cum; the raw stage is refilled at once.  Every warpgroup
// waits for every item and releases it (so that no stage is released twice
// in a phase) and computes only the slabs up to its diagonal.  With kTerm,
// from the second chunk on, a head's y starts at exp(cum_i) C_m . h_c^T,
// h_c loaded by TMA from `states` and split by the producer warps once per
// head (kSplitH).  y rows below Q are stored from the fragments after the
// warpgroup's last slab.  Fragments: thread 32 w + 4 g + c of a warpgroup
// holds rows 16 w + g and + 8 of its tile.
template <int NR, bool kTerm, int kTiles>
__global__ void __launch_bounds__(wg_threads<kTiles>(), 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap th,
                 const float* __restrict__ dA, float* __restrict__ y, int S, int H, int Q,
                 int group) {
  const int T = (Q + 63) / 64;   // <= kTiles
  const WgSmem L = wg_smem(T, NR, kTerm);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* cs = base + L.c;               // [T][NR] C tiles
  unsigned char* raw = base + L.raw;            // [kRawStages] float32 xdt
  unsigned char* cv = base + L.cv;              // [kCvStages] xdt hi, lo, B
  float* h_raw = reinterpret_cast<float*>(base + L.h_raw);   // [64][N]
  unsigned char* h_hi = base + L.h_split;       // [NR] 64 rows of h_c, K-major
  unsigned char* h_lo = h_hi + NR * kRegion;
  float* cums = reinterpret_cast<float*>(base + L.cum);      // [2][kMaxChunk]: heads hh & 1
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* b_full = raw_full + kRawStages;     // B landed in a split stage
  uint64_t* cv_full = b_full + kCvStages;       // xdt split (and cum written)
  uint64_t* cv_empty = cv_full + kCvStages;
  uint64_t* c_full = cv_empty + kCvStages;
  uint64_t* hraw_full = c_full + 1;
  uint64_t* h_full = c_full + 2;
  uint64_t* h_empty = c_full + 3;

  const int n_chunks = S / Q;
  const int n_groups = (H + group - 1) / group;
  int idx = blockIdx.x;
  const int h0 = (idx % n_groups) * group;
  idx /= n_groups;
  const int chunk = idx % n_chunks;
  const int b = idx / n_chunks;
  const int gh = min(group, H - h0);
  const int tok0 = b * S + chunk * Q;           // the chunk's first row of [B S]
  const int n_slabs = (Q + kWgSlab - 1) / kWgSlab;   // >= 2: Q >= 64
  const int items = gh * n_slabs;
  const bool term = kTerm && chunk > 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < kRawStages; ++i) mbar_init(&raw_full[i], 1);
    for (int i = 0; i < kCvStages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&cv_full[i], kProducerWarps);
      mbar_init(&cv_empty[i], 4 * T);
    }
    mbar_init(c_full, 1);
    mbar_init(hraw_full, 1);
    mbar_init(h_full, 1);
    mbar_init(h_empty, 4 * T);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * T) {
    // The producer warps: warp pw splits rows [8 pw, 8 pw + 8) of every xdt
    // slab (and 16 rows of h_c); thread 0 of them issues every TMA copy;
    // warp 0 also scans each head's dA into cum (two heads' slots, which a
    // head's last slab frees before the head after next needs it: >= 2
    // slabs a head, 3 split stages).
    const int ptid = tid - 128 * T;
    const int pw = ptid >> 5;
    const bool issuer = ptid == 0;
    auto producer_sync = [] {
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kProducerWarps) : "memory");
    };
    const CUtensorMap* mx = &tx;
    const CUtensorMap* mb = &tb;
    const CUtensorMap* mc = &tc;
    const CUtensorMap* mh = &th;
    auto issue_x = [&](int i) {
      const int hh = i / n_slabs;
      uint64_t* bar = &raw_full[i % kRawStages];
      mbar_expect_tx(bar, kRawX);
      tma_load_3d(raw + (i % kRawStages) * kRawX, mx, bar, 0, h0 + hh,
                  tok0 + kWgSlab * (i - hh * n_slabs));
    };
    auto issue_h = [&](int hh) {
      mbar_expect_tx(hraw_full, NR * 64 * kWgP * 4);
      tma_load_2d(h_raw, mh, hraw_full, 0, ((b * n_chunks + chunk) * H + h0 + hh) * kWgP);
    };
    if (issuer) {
      mbar_expect_tx(c_full, T * NR * kRegion);
      for (int m = 0; m < T; ++m)
        for (int r = 0; r < NR; ++r)
          tma_load_2d(cs + (m * NR + r) * kRegion, mc, c_full, 64 * r, tok0 + 64 * m);
      for (int i = 0; i < kRawStages && i < items; ++i) issue_x(i);
      if (term) issue_h(0);
    }
    // A head's dA, strided by H in memory (warp 0): the next head's is
    // loaded while this one's slabs are split.
    constexpr int kDa = kMaxChunk / 32;
    float da[kDa];
    auto load_da = [&](int hh) {
#pragma unroll
      for (int k = 0; k < kDa; ++k) {
        const int j = lane + 32 * k;
        da[k] = j < Q ? dA[static_cast<size_t>(tok0 + j) * H + h0 + hh] : 0.0f;
      }
    };
    if (pw == 0) load_da(0);
    for (int i = 0; i < items; ++i) {
      const int hh = i / n_slabs;
      const int s = i - hh * n_slabs;
      const int rs = i % kRawStages;
      const int st = i % kCvStages;
      if (i >= kCvStages) mbar_wait(&cv_empty[st], ((i / kCvStages) + 1) & 1);
      unsigned char* dst = cv + st * cv_stage_bytes(NR);
      if (issuer) {
        mbar_expect_tx(&b_full[st], NR * kSlabRegion);
        for (int r = 0; r < NR; ++r)
          tma_load_2d(dst + (2 + r) * kSlabRegion, mb, &b_full[st], 64 * r,
                      tok0 + kWgSlab * s);
      }
      if (s == 0) {
        if (pw == 0) {
          float* cum = cums + (hh & 1) * kMaxChunk;
#pragma unroll
          for (int k = 0; k < kDa; ++k)
            if (lane + 32 * k < Q) cum[lane + 32 * k] = da[k];
          __syncwarp();
          warp_scan(cum, Q, lane);
          if (hh + 1 < gh) load_da(hh + 1);
        }
        if (term) {
          mbar_wait(hraw_full, hh & 1);
          if (hh > 0) mbar_wait(h_empty, (hh - 1) & 1);   // every warpgroup's term is done
          constexpr int kHRows = kWgP / kProducerWarps;   // rows of h_c a producer warp splits
          for (int e = lane; e < kHRows * 16 * NR; e += 32) {
            const int p = kHRows * pw + e / (16 * NR);
            const int n = 4 * (e % (16 * NR));
            split_store(h_hi, h_lo, *reinterpret_cast<const float4*>(h_raw + p * 64 * NR + n), p,
                        n);
          }
          fence_async_smem();
          producer_sync();   // every producer warp's split is done
          if (issuer) {
            mbar_arrive(h_full);
            if (hh + 1 < gh) issue_h(hh + 1);
          }
        }
      }
      mbar_wait(&raw_full[rs], (i / kRawStages) & 1);
      const float* rx = reinterpret_cast<const float*>(raw + rs * kRawX);
      constexpr int kRowsPw = kWgSlab / kProducerWarps;
      float4 v[kRowsPw / 2];
#pragma unroll
      for (int k = 0; k < kRowsPw / 2; ++k) {
        const int e = lane + 32 * k;   // row kRowsPw pw + e / 16, columns 4 (e % 16) ..
        v[k] = *reinterpret_cast<const float4*>(rx + (kRowsPw * pw + (e >> 4)) * kWgP +
                                                4 * (e & 15));
      }
#pragma unroll
      for (int k = 0; k < kRowsPw / 2; ++k) {
        const int e = lane + 32 * k;
        split_store(dst, dst + kSlabRegion, v[k], kRowsPw * pw + (e >> 4), 4 * (e & 15));
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&cv_full[st]);
      // Every producer warp has read raw stage rs: TMA refills it.
      producer_sync();
      if (issuer && i + kRawStages < items) issue_x(i + kRawStages);
    }
    return;
  }

  // A consumer warpgroup.  Per head, slab by slab: C . B^T of slab s + 1 is
  // issued before the scores of slab s are formed on the CUDA cores, and
  // runs meanwhile (into the other of two score sets; kOverlap, the
  // smaller block), or after them (one set); then y's products of slab s
  // run as a stage of their own.  No other instruction defines a wgmma
  // input inside a stage, and no wgmma sits on a divergent path, so ptxas
  // keeps the products asynchronous.
  constexpr bool kOverlap = kTiles < 4;
  const int m = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int ra = 64 * m + 16 * w + g;              // this thread's chunk rows ra, ra + 8
  const int rb = ra + 8;
  const int s_last = min(2 * m + 1, n_slabs - 1);  // the tile's diagonal slab (>= 1)
  const unsigned char* ct = cs + m * NR * kRegion;
  const size_t y_tok = static_cast<size_t>(H) * kWgP;
  float acc[kWgP / 2];          // y: m64n64
  float sc[kOverlap ? 2 : 1][kWgSlab / 2];   // C_m . B_s^T (of alternate slabs): m64n32
  uint32_t fh[2][4], fl[2][4];  // [k16 step]: the scores split hi, lo
  auto stage = [&](int i) { return cv + (i % kCvStages) * cv_stage_bytes(NR); };
  auto ready = [&](int i) { mbar_wait(&cv_full[i % kCvStages], (i / kCvStages) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&cv_empty[i % kCvStages]);
  };
  // C_m . B^T of item i into d, both K-major (k16 steps 32 bytes apart).
  auto issue_cb = [&](int i, float (&d)[kWgSlab / 2]) {
    mbar_wait(&b_full[i % kCvStages], (i / kCvStages) & 1);
    const unsigned char* bt = stage(i) + 2 * kSlabRegion;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < 4 * NR; ++kd) {
      const int o = (kd & 3) * 32;
      wgmma_ss<kWgSlab, 0>(d, desc_sw128(ct + (kd >> 2) * kRegion + o),
                           desc_sw128(bt + (kd >> 2) * kSlabRegion + o), kd > 0);
    }
    wgmma_commit();
  };
  mbar_wait(c_full, 0);
  for (int hh = 0; hh < gh; ++hh) {
    const int i0 = hh * n_slabs;
    const float* cum = cums + (hh & 1) * kMaxChunk;
    ready(i0);
    const float cum_a = ra < Q ? cum[ra] : 0.0f;
    const float cum_b = rb < Q ? cum[rb] : 0.0f;
#pragma unroll
    for (int k = 0; k < kWgP / 2; ++k) acc[k] = 0.0f;
    if (term) {
      // acc = exp(cum_i) C_m . h_c^T: C exact, h_c split (K = N).
      mbar_wait(h_full, hh & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4 * NR; ++kd) {
        const int o = (kd >> 2) * kRegion + (kd & 3) * 32;
        const uint64_t dc = desc_sw128(ct + o);
        wgmma_ss<kWgP, 0>(acc, dc, desc_sw128(h_hi + o), 1);
        if (kSplitH) wgmma_ss<kWgP, 0>(acc, dc, desc_sw128(h_lo + o), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(h_empty);
      const float ea = expf(cum_a);
      const float eb = expf(cum_b);
#pragma unroll
      for (int k = 0; k < kWgP / 2; ++k) acc[k] *= (k & 2) ? eb : ea;
    }
    fence_regs(acc);
    issue_cb(i0, sc[0]);
    wgmma_wait<0>();
    fence_regs(sc[0]);
    // Slab s, its C . B^T in score set f (the next slab's in set fn);
    // kNext: there is a slab after it.
    auto slab = [&](int s, auto set, auto has_next) {
      constexpr int f = decltype(set)::value;
      constexpr int fn = kOverlap ? f ^ 1 : f;
      constexpr bool kNext = decltype(has_next)::value;
      const int i = i0 + s;
      if (kNext && kOverlap) {
        ready(i + 1);
        issue_cb(i + 1, sc[fn]);
      }
      // Scores C_i . B_j exp(cum_i - cum_j) for j <= i < Q, else 0: sc[f][8
      // kk + 2 q] and the next are row (q & 1 ? rb : ra), token 32 s + 16 kk
      // + 8 (q >> 1) + 2 c and the next.  Every exponential is taken (the
      // select drops those of masked entries), so that all sixteen are
      // independent.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = (q & 1) ? rb : ra;
          const float ci = (q & 1) ? cum_b : cum_a;
          const int j = kWgSlab * s + 16 * kk + 8 * (q >> 1) + 2 * c;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float e0 = expf(ci - cj.x);
          const float e1 = expf(ci - cj.y);
          const bool live = row < Q;
          const float s0 = (live && j <= row) ? sc[f][8 * kk + 2 * q] * e0 : 0.0f;
          const float s1 = (live && j + 1 <= row) ? sc[f][8 * kk + 2 * q + 1] * e1 : 0.0f;
          split_bf16(s0, s1, fh[kk][q], fl[kk][q]);
        }
      if (kNext && !kOverlap) {
        ready(i + 1);
        issue_cb(i + 1, sc[fn]);
      }
      wgmma_wait<0>();   // C . B^T of slab s + 1
      fence_regs(sc[fn]);
      // y += scores . xdt: xdt MN-major, a k16 step 16 token rows (2048 bytes).
      const unsigned char* in = stage(i);
      fence_regs(fh);
      fence_regs(fl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t dh = desc_sw128(in + kk * 2048);
        const uint64_t dl = desc_sw128(in + kSlabRegion + kk * 2048);
        wgmma_rs<kWgP, 1>(acc, fh[kk], dh, 1);
        wgmma_rs<kWgP, 1>(acc, fh[kk], dl, 1);
        wgmma_rs<kWgP, 1>(acc, fl[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(i);
    };
    using Set0 = std::integral_constant<int, 0>;
    using Set1 = std::integral_constant<int, kOverlap ? 1 : 0>;
    int s = 0;
    for (; s + 2 <= s_last; s += 2) {
      slab(s, Set0{}, std::true_type{});
      slab(s + 1, Set1{}, std::true_type{});
    }
    if (s == s_last) {
      slab(s, Set0{}, std::false_type{});
    } else {
      slab(s, Set0{}, std::true_type{});
      slab(s + 1, Set1{}, std::false_type{});
    }
    float* yh = y + static_cast<size_t>(tok0) * y_tok + static_cast<size_t>(h0 + hh) * kWgP;
#pragma unroll
    for (int j = 0; j < kWgP / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (ra < Q)
        *reinterpret_cast<float2*>(yh + ra * y_tok + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (rb < Q)
        *reinterpret_cast<float2*>(yh + rb * y_tok + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    // The slabs past the tile's diagonal: waited for and released, so
    // that every stage's phase counts every warp once.
    for (int s2 = s_last + 1; s2 < n_slabs; ++s2) {
      ready(i0 + s2);
      release(i0 + s2);
    }
  }
}

// The shapes the Hopper body takes: P = 64, N a whole number of 128-byte
// swizzle rows (64 or 128), at least one whole M tile of rows (Q >= 64);
// the rest keep the mma.sync body.
bool wgmma_shape(int P, int N, int Q) {
  return kWgmmaBody && P == kWgP && (N == 64 || N == 128) && Q >= 64;
}

// The Hopper body's instance for a shape: N = 64 NR, the carried-state
// term with more than one chunk, blocks built for 3 tiles up to Q = 192
// and for 4 above.
using WgKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float*,
                          float*, int, int, int, int);
struct WgInstance {
  WgKernel kernel;
  int threads;
  WgSmem smem;
};

template <int kTiles>
WgInstance wg_instance_for(int N, bool term, int Q) {
  const int tiles = (Q + 63) / 64;
  const int threads = 128 * tiles + 32 * kProducerWarps;
  const WgSmem smem = wg_smem(tiles, N / 64, term);
  if (N == 64)
    return {term ? &ssd_wgmma_kernel<1, true, kTiles> : &ssd_wgmma_kernel<1, false, kTiles>,
            threads, smem};
  return {term ? &ssd_wgmma_kernel<2, true, kTiles> : &ssd_wgmma_kernel<2, false, kTiles>,
          threads, smem};
}

WgInstance wg_instance(int N, bool term, int Q) {
  return Q <= 192 ? wg_instance_for<3>(N, term, Q) : wg_instance_for<4>(N, term, Q);
}

// Heads per block of the Hopper body: the group that finishes the grid in
// the fewest rounds of (heads + 1), one head's time a round for a block's
// set-up, with as many blocks at once as fit on the card.
int wgmma_group(const WgInstance& inst, int B, int S, int H, int Q, int device) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(inst.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           inst.smem.bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.kernel, inst.threads,
                                                    inst.smem.bytes) != cudaSuccess)
    per_sm = 1;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count(device);
  const long long chunks = static_cast<long long>(B) * (S / Q);
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= H; ++g) {
    const long long blocks = chunks * ((H + g - 1) / g);
    const long long cost = (blocks + slots - 1) / slots * (g + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = g;
    }
  }
  return best;
}

// The tensor maps: xdt as [B S][H][64] float32 in boxes of (64, 1 head, 32
// tokens), B and C as [B S][N] bf16 in boxes of (64, 32 tokens) and (64,
// 64 rows) under the 128-byte swizzle, states as [B nc H 64][N] float32 in
// boxes of (N, 64 rows); the float32 boxes unswizzled.
int launch_wgmma(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm,
                 const float* states, float* y, int B, int S, int H, int N, int Q, int device,
                 cudaStream_t stream) {
  const bool term = S / Q > 1;
  const uint64_t rows = static_cast<uint64_t>(B) * S;
  const uint64_t n = static_cast<uint64_t>(N);
  const uint64_t x_dims[3] = {kWgP, static_cast<uint64_t>(H), rows};
  const uint64_t x_strides[2] = {kWgP * 4, static_cast<uint64_t>(H) * kWgP * 4};
  const uint32_t x_box[3] = {kWgP, 1, kWgSlab};
  const uint64_t bc_dims[2] = {n, rows};
  const uint64_t bc_strides[1] = {n * 2};
  const uint32_t b_box[2] = {64, kWgSlab};
  const uint32_t c_box[2] = {64, 64};
  CUtensorMap tx, tb, tc, th;
  int err = wgmma_tiles::make_tensor_map(&tx, xdt, 3, x_dims, x_strides, x_box,
                                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0) err = wgmma_tiles::make_tensor_map(&tb, Bm, 2, bc_dims, bc_strides, b_box);
  if (err == 0) err = wgmma_tiles::make_tensor_map(&tc, Cm, 2, bc_dims, bc_strides, c_box);
  if (err == 0 && term) {
    const uint64_t h_dims[2] = {n, static_cast<uint64_t>(B) * (S / Q) * H * kWgP};
    const uint64_t h_strides[1] = {n * 4};
    const uint32_t h_box[2] = {static_cast<uint32_t>(N), kWgP};
    err = wgmma_tiles::make_tensor_map(&th, states, 2, h_dims, h_strides, h_box,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                       CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    th = tx;   // not read
  }
  if (err != 0) return err;
  const WgInstance inst = wg_instance(N, term, Q);
  err = static_cast<int>(cudaFuncSetAttribute(
      inst.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, inst.smem.bytes));
  if (err != 0) return err;
  const int group = wgmma_group(inst, B, S, H, Q, device);
  const long long blocks = static_cast<long long>(B) * (S / Q) * ((H + group - 1) / group);
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  inst.kernel<<<static_cast<unsigned>(blocks), inst.threads, inst.smem.bytes, stream>>>(
      tx, tb, tc, th, dA, y, S, H, Q, group);
  return static_cast<int>(cudaGetLastError());
}

// TMA takes 16-byte-aligned tensors; a misaligned view keeps the mma.sync body.
bool wgmma_aligned(const void* a, const void* b, const void* c, const void* d) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16 == 0;
}

// bf16 B/C: with more than one chunk or a final state to write, the state
// kernel first (the state entering each chunk into `states`, the final
// state into hout); then the chunk kernel, which adds the carried-state
// term exp(cum_i) C_i . h_c^T from `states` to its own accumulators from
// the second chunk on: the Hopper body where the shape fits it, else the
// mma.sync body.  Nothing is launched on the CUDA cores.
int launch_bf16(const float* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
                float* hout, float* states, int B, int S, int H, int P, int N, int Q,
                int device, cudaStream_t stream) {
  const bf16* b = static_cast<const bf16*>(Bm);
  const bf16* c = static_cast<const bf16*>(Cm);
  const bool inter = S / Q > 1;   // the carried-state term exp(cum_i) C_i . h_c^T
  if (inter || hout != nullptr) {
    const int err = launch_state(xdt, dA, b, states, hout, B, S, H, P, N, Q, stream);
    if (err != 0) return err;
  }
  if (wgmma_shape(P, N, Q) && wgmma_aligned(xdt, Bm, Cm, inter ? states : xdt))
    return launch_wgmma(xdt, dA, b, c, states, y, B, S, H, N, Q, device, stream);
  return inter ? launch_mma<true>(xdt, dA, b, c, states, y, B, S, H, P, N, Q, device, stream)
               : launch_mma<false>(xdt, dA, b, c, states, y, B, S, H, P, N, Q, device, stream);
}

bool bad_shape(int B, int S, int H, int P, int N, int Q) {
  return B <= 0 || S <= 0 || H <= 0 || Q < 1 || Q > kMaxChunk || S % Q != 0 || P < 1 ||
         P > kMaxP || N < 1 || N > kMaxN || static_cast<int64_t>(B) * H > 0x7fffffff;
}

}  // namespace

// xdt and y [B, S, H, P] float32, dA [B, S, H] float32, Bm and Cm [B, S, N]
// (dtype 0: float32, 1: bfloat16), all contiguous; 1 <= Q <= 256 divides S,
// P <= 128, N <= 256.  hout [B, H, P, N] float32 receives the final state,
// or is null.  states [B, S / Q, H, P, N] float32 (bf16 with more than one
// chunk; else may be null) receives the state entering each chunk c >= 1
// (entry 0 is not written), which the chunk kernel reads back and
// ssd_scan_bwd_launch can take.  Launches on `stream` (PyTorch's current
// stream): float32 B/C the CUDA-core body; bf16 the tensor-core kernels
// (the state kernel, with more than one chunk or a final state to write,
// then the chunk kernel).  Returns the cudaError_t of the launches; 0 means
// they were queued.
extern "C" int ssd_scan_launch(const float* xdt, const float* dA, const void* Bm,
                               const void* Cm, float* y, float* hout, float* states, int B,
                               int S, int H, int P, int N, int Q, int dtype, int device,
                               void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || (dtype == 1 && S / Q > 1 && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_scan<float>(xdt, dA, Bm, Cm, y, hout, B, S, H, P, N, Q, s);
    case 1:
      return launch_bf16(xdt, dA, Bm, Cm, y, hout, states, B, S, H, P, N, Q, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Heads per block that ssd_scan_launch gives the chunk kernel (bf16 B/C,
// 16-byte-aligned tensors) at this shape on `device`; -1 for a shape it
// refuses.
extern "C" int ssd_scan_heads_per_block(int B, int S, int H, int P, int N, int Q,
                                        int device) {
  if (bad_shape(B, S, H, P, N, Q)) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  return wgmma_shape(P, N, Q) ? wgmma_group(wg_instance(N, S / Q > 1, Q), B, S, H, Q, device)
                              : heads_per_block(B, S, H, Q, device);
}

// 1 where the bf16 chunk kernel at this shape (16-byte-aligned tensors) is
// the Hopper body (`ssd_wgmma_kernel`), 0 where it is the mma.sync body.
extern "C" int ssd_scan_wgmma(int P, int N, int Q) { return wgmma_shape(P, N, Q) ? 1 : 0; }
