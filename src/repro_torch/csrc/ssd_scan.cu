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
//
// What bounds it: at the main path's shape (mamba2-2.7b, 128 rows x 160
// tokens, H = 80, P = 64, N = 128, one chunk of Q = 160) the work is about
// 1.8e10 float32 flops against 856 MB of xdt, y, dA, B and C: the two
// bounds are close (~265 us and ~255 us on the H100).  This first kernel
// does more than that work: it recomputes C . B^T for every head (B and C
// are shared by all heads) and whole 32 x 32 tiles on the diagonal, on the
// CUDA cores in float32 (67 TFLOP/s), with shared-memory operands.
//
// Design: one block of 256 threads per (batch, head) walks its chunks in
// order; the state stays in shared memory for the whole walk ([P][N + 4]
// floats, 33 KB at P = 64, N = 128).  A chunk does not fit in shared memory
// at Q = 256 (a float32 [Q, N] tile of B or C alone is 128 KB), so it is
// streamed in 32-row tiles: cum is a warp scan of dA over the chunk; for
// each row tile i, C_i is loaded once, and for each tile j <= i the block
// loads B_j and xdt_j, forms the 32 x 32 scores (C_i . B_j^T) * exp(cum_i -
// cum_j) under the causal mask in shared memory, and accumulates their
// product with xdt_j in registers; then adds exp(cum_i) C_i . h^T and writes
// y_i.  After the chunk the state is updated, except after the last chunk,
// where nothing reads it (the Pallas scratch dies with the grid, and the
// wrapper returns only y); with one chunk neither the state term nor the
// update runs.  Warp w owns tile rows w, w + 8, w + 16, w + 24; lane l owns
// score column l and output columns l + 32k.  Any 1 <= Q <= 256 that
// divides S, P <= 128 and N <= 256 are accepted.  Accurate expf, no fast
// math.  Sharing C . B^T across heads, tensor cores (mma / wgmma in TF32 or
// bf16) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // chunk rows per tile
constexpr int kRowsPerWarp = kTile / kWarps;   // 4
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMaxPK = kMaxP / 32;             // output columns per lane
constexpr int kMaxNK = kMaxN / 32;             // state columns per lane
constexpr int kStateRows = 8;                  // state rows per warp per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row stride (floats) of the B, C and state tiles: N rounded up to 4 (for
// float4 reads), plus 4 so that the 8 lanes of a float4 phase hit distinct
// banks.
__host__ __device__ __forceinline__ int row_stride(int N) {
  return ((N + 3) & ~3) + 4;
}

size_t smem_bytes(int P, int N, int Q) {
  const size_t ns = row_stride(N);
  return sizeof(float) * (P * ns               // state h[p][n]
                          + 2 * kTile * ns     // C_i and B_j rows
                          + kTile * P          // xdt_j rows
                          + kTile * kTile      // scores
                          + Q);                // cum
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ns = row_stride(N);
  float* hs = smem;                    // [P][ns]      carried state
  float* cs = hs + P * ns;             // [kTile][ns]  C rows of tile i
  float* bs = cs + kTile * ns;         // [kTile][ns]  B rows of tile j
  float* xs = bs + kTile * ns;         // [kTile][P]   xdt rows of tile j
  float* ss = xs + kTile * P;          // [kTile][kTile] scores of (i, j)
  float* cum = ss + kTile * kTile;     // [Q]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = S / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int n_vec = (N + 3) & ~3;
  const size_t x_stride = static_cast<size_t>(H) * P;     // between tokens
  const float* xb = xdt + (static_cast<size_t>(b) * S * H + h) * P;
  float* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  const float* ab = dA + static_cast<size_t>(b) * S * H + h;
  const T* bb = Bm + static_cast<size_t>(b) * S * N;
  const T* cb = Cm + static_cast<size_t>(b) * S * N;

  if (n_chunks > 1)
    for (int e = threadIdx.x; e < P * ns; e += kThreads) hs[e] = 0.0f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the previous chunk is done with cum and the tiles
    for (int i = threadIdx.x; i < Q; i += kThreads)
      cum[i] = ab[static_cast<size_t>(t0 + i) * H];
    __syncthreads();
    if (warp == 0) {  // inclusive scan, 32 entries at a time
      float carry = 0.0f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? cum[i] : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }

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

    if (ci == n_chunks - 1) break;  // nothing reads the last chunk's state

    // h <- exp(total) h + sum_j (exp(total - cum_j) xdt_j)^T B_j, in passes
    // of kWarps * kStateRows state rows; lane l owns columns l + 32k.
    float* w_end = ss;  // the scores tile is free here: kTile weights
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
          if (n < N) hs[p * ns + n] = hs[p * ns + n] * keep + sacc[m][kn];
        }
      }
    }
  }
}

template <typename T>
int launch(const float* xdt, const float* dA, const void* Bm, const void* Cm,
           float* y, int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      xdt, dA, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, S, H, P,
      N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xdt and y [B, S, H, P] float32, dA [B, S, H] float32, Bm and Cm [B, S, N]
// (dtype 0: float32, 1: bfloat16), all contiguous; 1 <= Q <= 256 divides S,
// P <= 128, N <= 256.  Launches on `stream` (PyTorch's current stream).
// Returns the cudaError_t of the launch; 0 means it was queued.
extern "C" int ssd_scan_launch(const float* xdt, const float* dA, const void* Bm,
                               const void* Cm, float* y, int B, int S, int H,
                               int P, int N, int Q, int dtype, int device,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q < 1 || Q > kMaxChunk || S % Q != 0 ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      static_cast<int64_t>(B) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(xdt, dA, Bm, Cm, y, B, S, H, P, N, Q, s);
    case 1:
      return launch<__nv_bfloat16>(xdt, dA, Bm, Cm, y, B, S, H, P, N, Q, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
