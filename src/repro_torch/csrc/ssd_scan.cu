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
// products of the scores with xdt are 2.0e10 flops: on the tensor cores
// that is far under the byte floor, on the CUDA cores (67 TFLOP/s float32)
// it is not.
//
// bf16 B and C: the tensor-core body (`ssd_mma_kernel`), for the part of
// y inside each chunk.  One block of 8 warps per (batch, chunk, tile of 64
// chunk rows, group of up to 16 heads); the group is sized from the shape
// so that the grid fills the card (phase 13: 16 heads, 1920 blocks;
// zamba2's 8 rows x 112 heads: 4 heads, 672 blocks), and the last group of
// a row takes the heads that are left.  Heaviest row tile first.
//
// * C . B^T once per block, for all its heads: `mma.sync.m16n8k16` bf16
//   in, float32 out (the bf16 products are exact, so only the order of
//   summation differs from the float32 plain version), over the causal
//   16 x 16 tiles only, into shared memory as float32 ([64][Q + 8]: 43 KB at
//   Q = 160).  C rows and 32-row slabs of B come in by 16-byte `cp.async`;
//   Q, N and P are padded to the tile edges with zeros.
// * cum for every head of the group is scanned once (a warp scan, 32 entries
//   at a time, as the CUDA-core body does it).
// * Then the block's two halves of 4 warps (one per 16 rows) walk alternate
//   heads independently, each with its own barrier, so only one head's y
//   accumulators (16 rows x P per warp, in mma fragments) are live per
//   warp.  xdt comes in 32 rows at a time through each half's two-stage
//   ring of 16-byte `cp.async` loads, which runs on across its heads, and is
//   split once per half into hi = bf16(x) and lo = bf16(x - hi).  Each warp
//   forms the scores of a slab's 16-column steps up to its diagonal,
//   C_i . B_j * expf(cum_i - cum_j) (accurate expf, per head and element:
//   e^{cum_i} e^{-cum_j} would overflow, cum reaches -130 in a chunk), on the
//   fragments, splits them the same way and accumulates hi.hi + hi.lo +
//   lo.hi on the tensor cores in float32 (`ldmatrix.trans` gives the xdt
//   fragments).  One bf16 rounding of either operand misses the float32 bar
//   the kernel is held to (tests/test_torch_ssd_numerics.py); the split
//   meets it.  Tiles above the diagonal are never formed.
// * Shared memory at phase 13's shape: 43 KB of C . B^T, 10 KB of cum, 2 x
//   26 KB of xdt rings and splits: two blocks (16 warps) per SM.
// * With more than one chunk, or when the final state is asked for, the
//   state kernel follows (`ssd_fwd_state_mma_kernel`, the body of
//   ssd_state.cuh that the backward's state pass also runs): one block of 8
//   warps per (batch, head, 64 state rows) walks the chunks in order, h <-
//   exp(total) h + (w o xdt)^T B as an MMA over 32-token slabs through a
//   3-deep cp.async ring (w o xdt split hi + lo, B exact), and writes the
//   state entering each chunk to float32 `states` [B, nc, H, P, N], the
//   layout the backward reads (autograd saves it, so the backward runs only
//   its reverse direction), and the final state to hout.  From the second
//   chunk on it first adds exp(cum_i) C_i . h^T to y for its 64 columns of
//   P: the state it holds in registers is staged split hi + lo in shared
//   memory, and each warp forms 16 tokens at a time against it (C rows and
//   y read from global memory, C exact: two products per k16 step, K = N)
//   while its ring brings in the chunk's first slabs.  y is read back once
//   for those chunks.
// * The other place for that term, kept for launch/ssd_fwd_sweep.py
//   (kInterInChunk): the state kernel first, then the chunk kernel starting
//   each head's accumulators of a chunk c > 0 at exp(cum_i) C_i . h_c^T, h_c
//   read from `states` and split as it is read.  y is then written once,
//   but every warp reads all of h_c from global memory in 8-byte pieces
//   that each touch 8 rows, and nothing hides their latency: at 24(c)'s
//   mamba2 shape the term costs ~310 us of the chunk kernel, against ~84 us
//   in the state kernel (H100, launch/ssd_fwd_sweep.py).  One chunk without
//   hout launches the chunk kernel alone, its code unchanged by the term (a
//   template flag).
// * At 24(c)'s training shape (8 rows x 512 tokens, two chunks of 256,
//   mamba2-2.7b's heads) the least work is 1.10e10 float32 flops, 164 us
//   at 67 TFLOP/s (its 171 MB take 51 us); the chunk kernel's shared memory
//   (129 KB at Q = 256) holds it to one block an SM there, and the state
//   kernel runs one block an SM (its registers).
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
// The tensor-core body: bf16 B/C
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
// Where the inter-chunk term exp(cum_i) C_i . h^T is added
// (launch/ssd_fwd_sweep.py times both): false, the state kernel, after the
// chunk kernel, from the state it holds; true, the chunk kernel, after the
// state kernel, reading the state from global memory.
constexpr bool kInterInChunk = false;

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
        state_term<2 * PT, ssd_state::kSplitH>(
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
// last chunk into hout when given.  kAddY: it also adds exp(cum_i) C_i .
// h^T to y (!kInterInChunk).
template <int NPW, bool kAddY>
__global__ void __launch_bounds__(ssd_state::kStThreads, 1)
ssd_fwd_state_mma_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                         const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                         float* __restrict__ hs, float* __restrict__ hout,
                         float* __restrict__ y, int S, int H, int P, int N, int Q, int vec_bc,
                         int vec_u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ssd_state::state_pass<NPW, kAddY>(smem_raw, xdt, dA, Bm, Cm, nullptr, hs, nullptr, hout, y,
                                    false, S, H, P, N, Q, vec_bc, vec_u);
}

template <bool kAddY>
int launch_state(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm, float* hs,
                 float* hout, float* y, int B, int S, int H, int P, int N, int Q,
                 cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H * ((P + 63) / 64);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const int vec_u = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  return static_cast<int>(ssd_state::with_npw(N, [&](auto npw) {
    constexpr int NPW = decltype(npw)::value;
    const size_t smem = ssd_state::state_smem_bytes(N, Q, kAddY);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(ssd_fwd_state_mma_kernel<NPW, kAddY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    ssd_fwd_state_mma_kernel<NPW, kAddY>
        <<<static_cast<unsigned>(blocks), ssd_state::kStThreads, smem, stream>>>(
            xdt, dA, Bm, Cm, hs, hout, y, S, H, P, N, Q, vec_bc, vec_u);
    return cudaGetLastError();
  }));
}

// bf16 B/C: the chunk kernel, then, with more than one chunk or a final
// state to write, the state kernel, which writes the state entering each
// chunk into `states` (and the final state into hout) and adds exp(cum_i)
// C_i . h^T to y from the second chunk on.  Nothing is launched on the CUDA
// cores.
int launch_bf16(const float* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
                float* hout, float* states, int B, int S, int H, int P, int N, int Q,
                int device, cudaStream_t stream) {
  const bf16* b = static_cast<const bf16*>(Bm);
  const bf16* c = static_cast<const bf16*>(Cm);
  const bool inter = S / Q > 1;   // the inter-chunk term exp(cum_i) C_i . h^T
  const bool state_pass = inter || hout != nullptr;
  int err = 0;
  if (kInterInChunk) {
    if (state_pass)
      err = launch_state<false>(xdt, dA, b, c, states, hout, nullptr, B, S, H, P, N, Q, stream);
    if (err != 0) return err;
    return inter ? launch_mma<true>(xdt, dA, b, c, states, y, B, S, H, P, N, Q, device, stream)
                 : launch_mma<false>(xdt, dA, b, c, states, y, B, S, H, P, N, Q, device, stream);
  }
  err = launch_mma<false>(xdt, dA, b, c, states, y, B, S, H, P, N, Q, device, stream);
  if (err != 0 || !state_pass) return err;
  return inter ? launch_state<true>(xdt, dA, b, c, states, hout, y, B, S, H, P, N, Q, stream)
               : launch_state<false>(xdt, dA, b, c, states, hout, nullptr, B, S, H, P, N, Q,
                                     stream);
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
// (entry 0 is not written), which ssd_scan_bwd_launch can take.  Launches
// on `stream` (PyTorch's current stream): float32 B/C the CUDA-core body;
// bf16 the tensor-core kernels (the state kernel, with more than one chunk
// or a final state to write, then the chunk kernel).  Returns the
// cudaError_t of the launches; 0 means they were queued.
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

// Heads per block that ssd_scan_launch gives the tensor-core body (bf16
// B/C) at this shape on `device`; -1 for a shape it refuses.
extern "C" int ssd_scan_heads_per_block(int B, int S, int H, int P, int N, int Q,
                                        int device) {
  if (bad_shape(B, S, H, P, N, Q)) return -1;
  return heads_per_block(B, S, H, Q, device);
}
