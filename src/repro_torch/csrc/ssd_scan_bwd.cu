// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a).
//
// The TPU kernel `ssd_scan_fwd` (src/repro/kernels/ssd_scan/ssd_scan.py)
// has no Pallas backward: the reference trains through XLA's autograd of
// `ssd_chunked` (src/repro/models/ssm.py).  This is the gradient of the
// forward kernel's y (no final state), so that the port trains mamba2 and
// zamba2 through the forward kernel on the card.
//
// Per (batch b, head h) and chunk of Q tokens, with cum the running sum of
// dA from the chunk's start, total = cum[Q - 1], L_ij = exp(cum_i - cum_j)
// (j <= i), G = C B^T, M = G o L, w_j = exp(total - cum_j), h the state
// entering the chunk and g the gradient of the state leaving it (zero
// after the last chunk):
//
//   g of the chunk before  = exp(total) g + sum_i exp(cum_i) dy_i (x) C_i
//   dxdt_j = sum_i M_ij dy_i + w_j g B_j
//   dM = dy xdt^T, dG = dM o L
//   dC_i  = sum_j dG_ij B_j + exp(cum_i) h^T dy_i        (summed over heads)
//   dB_j  = sum_i dG_ij C_i + w_j g^T xdt_j              (summed over heads)
//   dcum_i = rowsum(dM o M)_i - colsum(dM o M)_i + dy_i . exp(cum_i) h C_i
//            - w_i xdt_i . g B_i,  and dcum[Q - 1] += exp(total) <g, h>
//            + sum_j w_j xdt_j . g B_j
//   ddA = the reverse running sum of dcum within the chunk.
//
// xdt, dy, dxdt [B, S, H, P] and dA, ddA [B, S, H] are float32; B, C, dB,
// dC [B, S, N] float32 or bfloat16 (dB and dC rounded once at the end).
//
// Three launches, CUDA-core float32 FMAs, no atomics (a repeated call
// gives the same bits):
//
// 1. `ssd_bwd_state_kernel` (only with more than one chunk): one block
//    per (batch, head, 32 rows of P) and direction.  Forward, it walks the
//    chunks in order and writes the state entering each chunk (the
//    forward's state pass, recomputed: the forward kernel keeps its y
//    bit-equal and saves nothing); backward, it walks them in reverse and
//    writes g, the gradient of the state leaving each chunk.  Float32
//    scratch [B, nc, H, P, N] each (42 MB each at mamba2's training shape).
// 2. `ssd_bwd_chunk_kernel`: one block of 256 threads per (batch, chunk,
//    head), everything of that chunk and head.  The chunk is streamed in
//    32-token tiles (a Q x Q float32 tile is 256 KB at Q = 256).  Pass A
//    walks column tiles j: the state terms of g first, then for every row
//    tile i >= j the 32 x 32 tiles G^T and dM^T (dot products over N and
//    P), L, M and dG, and their products with dy_i and C_i into dxdt_j and
//    dB_j (registers); dxdt is written, dB into per-head float32 scratch.
//    Pass B walks row tiles i the same way (tiles j <= i) into dC_i and
//    the state terms of h.  Each pass sums dM o M over its inner index
//    (a warp reduction), so dcum gathers rowsum - colsum, then the last
//    entry's total terms, and a warp scan from the end gives ddA.  The
//    state (g in pass A, h in pass B) sits in shared memory when it fits
//    beside the tiles at two blocks an SM (mamba2: 64 x 128), else in
//    slabs of 32 rows per tile.  G and dM are formed in both passes.
// 3. `ssd_bwd_reduce_kernel`: dB and dC summed over the heads in order
//    (B and C are shared by them), rounded to their type.
//
// What bounds it: at mamba2-2.7b's training shape (8 rows x 512 tokens,
// H = 80, P = 64, N = 128, Q = 256, bf16 B/C) the algorithm's products are
// ~4.9e10 float32 flops (C B^T once per (row, chunk), the causal halves
// of dM, M^T dy, dG B, dG^T C, and the four state products per chunk that
// has a state, with the two state passes), 0.73 ms at 67 TFLOP/s; it
// moves ~0.26 GB (xdt, dy and dxdt at 84 MB each), 77 us at 3.35 TB/s.
// The operations bound it.  This first design forms G and dM twice and
// reads its operands from shared memory for every FMA; the tensor cores
// (the forward's hi + lo split) are later work.
//
// Any 1 <= Q <= 256 that divides S, P <= 128 and N <= 256 are accepted,
// as the forward takes.  Accurate expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // chunk tokens per tile
constexpr int kRows = kTile / kWarps;        // tile rows per warp: w, w + 8, ...
constexpr int kMatLd = kTile + 4;            // row stride of the 32 x 32 tiles
constexpr int kStateNK = kMaxN / 32;         // state columns per lane (state kernel)
// Shared memory of the chunk kernel up to which the whole state is kept
// (two blocks an SM).
constexpr size_t kResidentBudget = 113 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round4(int k) { return (k + 3) & ~3; }
// Row stride (floats) of a tile of width k: a multiple of 4 (float4 reads)
// whose quarter is odd, so the 8 lanes of a float4 phase that read 8
// different rows hit distinct banks.
__host__ __device__ __forceinline__ int pad_ld(int k) { return (k + 7) / 8 * 8 + 4; }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive scan of a[0, len) in place by one warp, 32 entries at a time
// (the forward's); entries [len, round32(len)) get the running total.
__device__ __forceinline__ void warp_scan(float* a, int len, int lane) {
  float carry = 0.0f;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    float v = i < len ? a[i] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    a[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Reverse inclusive scan of a[0, len) in place by one warp: a[i] <- sum of
// a[i..len); entries [len, round32(len)) get 0.
__device__ __forceinline__ void warp_scan_rev(float* a, int len, int lane) {
  float carry = 0.0f;
  for (int base = (len + 31) / 32 * 32 - 32; base >= 0; base -= 32) {
    const int i = base + lane;
    float v = i < len ? a[i] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v += u;
    }
    v += carry;
    a[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 0);
  }
}

// kTile rows [r0, r0 + kTile) of a matrix with row stride `stride` into
// dst[kTile][ld] as float32, columns [0, round4(width)); zero at rows >=
// valid and columns >= width.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, size_t stride,
                                          int r0, int valid, int width) {
  const int w4 = round4(width);
  for (int e = threadIdx.x; e < kTile * w4; e += kThreads) {
    const int r = e / w4;
    const int k = e - r * w4;
    dst[r * ld + k] = (r0 + r < valid && k < width)
                          ? to_f32(src[static_cast<size_t>(r0 + r) * stride + k])
                          : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 1. The states entering each chunk and the state gradients leaving it
// ---------------------------------------------------------------------------

// Block (batch b, head h, rows [p0, p0 + 32) of P), blockIdx.y = 0: h_c for
// c = 1 .. nc - 1 into hs[b][c][h] (h_0 = 0 is never read); blockIdx.y = 1:
// g_c for c = nc - 2 .. 0 into gs[b][c][h] (g_{nc-1} = 0 is never read).
// Each step: state <- exp(total) state + sum_t wt_t u_t (x) v_t, with (u, v,
// wt) = (xdt, B, exp(total - cum)) forward and (dy, C, exp(cum)) backward.
// Warp w owns state rows p0 + w + 8m, lane l columns l + 32k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ hs,
                     float* __restrict__ gs, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ns = pad_ld(N);
  const int Qp = (Q + 31) & ~31;
  float* cum = smem;                       // [Qp]
  float* wt = cum + Qp;                    // [kTile]
  float* us = wt + kTile;                  // [kTile][33]  u rows of this slab
  float* vs = us + kTile * 33;             // [kTile][ns]

  const bool rev = blockIdx.y == 1;
  const int n_slabs = (P + 31) / 32;
  int idx = blockIdx.x;
  const int slab = idx % n_slabs;
  idx /= n_slabs;
  const int h = idx % H;
  const int b = idx / H;
  const int p0 = 32 * slab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nc = S / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const size_t x_stride = static_cast<size_t>(H) * P;
  const float* ub = (rev ? dy : xdt) + (static_cast<size_t>(b) * S * H + h) * P + p0;
  const T* vb = (rev ? Cm : Bm) + static_cast<size_t>(b) * S * N;
  const float* ab = dA + static_cast<size_t>(b) * S * H + h;
  float* out = rev ? gs : hs;

  float state[kRows][kStateNK];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int k = 0; k < kStateNK; ++k) state[m][k] = 0.0f;

  for (int step = 0; step + 1 < nc; ++step) {
    const int c = rev ? nc - 1 - step : step;
    const int t0 = c * Q;
    __syncthreads();  // the last chunk's readers of cum, wt, us, vs are done
    for (int i = threadIdx.x; i < Q; i += kThreads)
      cum[i] = ab[static_cast<size_t>(t0 + i) * H];
    __syncthreads();
    if (warp == 0) warp_scan(cum, Q, lane);
    __syncthreads();
    const float total = cum[Q - 1];

    float acc[kRows][kStateNK];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int k = 0; k < kStateNK; ++k) acc[m][k] = 0.0f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      const int valid = min(kTile, Q - j0);
      if (jt > 0) __syncthreads();
      if (threadIdx.x < kTile) {
        const int j = j0 + threadIdx.x;
        wt[threadIdx.x] =
            threadIdx.x < valid ? (rev ? expf(cum[j]) : expf(total - cum[j])) : 0.0f;
      }
      for (int e = threadIdx.x; e < kTile * 32; e += kThreads) {
        const int r = e >> 5;
        const int pc = e & 31;
        us[r * 33 + pc] = (r < valid && p0 + pc < P)
                              ? ub[static_cast<size_t>(t0 + j0 + r) * x_stride + pc]
                              : 0.0f;
      }
      load_tile(vs, ns, vb + static_cast<size_t>(t0) * N, N, j0, Q, N);
      __syncthreads();
      for (int r = 0; r < valid; ++r) {
        const float w = wt[r];
        float uw[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m) uw[m] = us[r * 33 + warp + kWarps * m] * w;
#pragma unroll
        for (int k = 0; k < kStateNK; ++k) {
          const int n = lane + 32 * k;
          if (n < N) {
            const float v = vs[r * ns + n];
#pragma unroll
            for (int m = 0; m < kRows; ++m) acc[m][k] = fmaf(uw[m], v, acc[m][k]);
          }
        }
      }
    }
    const float keep = expf(total);
    const int c_out = rev ? c - 1 : c + 1;
    float* dst = out + ((static_cast<size_t>(b) * nc + c_out) * H + h) * P * N;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int p = p0 + warp + kWarps * m;
#pragma unroll
      for (int k = 0; k < kStateNK; ++k) {
        const int n = lane + 32 * k;
        state[m][k] = state[m][k] * keep + acc[m][k];
        if (p < P && n < N) dst[static_cast<size_t>(p) * N + n] = state[m][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. One chunk of one head: dxdt, ddA and the head's dB, dC
// ---------------------------------------------------------------------------

struct ChunkSmem {
  int ns, pp, qp, st_rows;
};

__host__ __device__ __forceinline__ ChunkSmem chunk_smem(int P, int N, int Q, int SR) {
  return {pad_ld(N), pad_ld(P), (Q + 31) & ~31, round4(SR)};
}

__host__ __device__ __forceinline__ size_t chunk_smem_floats(int P, int N, int Q, int SR) {
  const ChunkSmem sh = chunk_smem(P, N, Q, SR);
  return 3 * sh.qp + kThreads + static_cast<size_t>(sh.st_rows) * sh.ns +
         2 * kTile * sh.ns + 2 * kTile * sh.pp + 2 * kTile * kMatLd;
}

// Rows [p0, p0 + rows) of a [P, N] float32 state into st[round4(rows)][ns];
// zero past the rows and at columns [N, round4(N)).
__device__ __forceinline__ void load_state(float* st, int ns, const float* src, int p0,
                                           int rows, int N) {
  const int n4 = round4(N);
  for (int e = threadIdx.x; e < round4(rows) * n4; e += kThreads) {
    const int r = e / n4;
    const int n = e - r * n4;
    st[r * ns + n] = (r < rows && n < N) ? src[static_cast<size_t>(p0 + r) * N + n] : 0.0f;
  }
}

// out[k] = sum_q A[(warp + 8k) * lda + q] * Bt[lane * ldb + q], q < k4 (a
// multiple of 4): the 32 x 32 tile A Bt^T at this thread's rows and column.
__device__ __forceinline__ void tile_nt(const float* A, int lda, const float* Bt, int ldb,
                                        int k4, int warp, int lane, float (&out)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) out[k] = 0.0f;
  const float* brow = Bt + lane * ldb;
  for (int q = 0; q < k4; q += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(brow + q);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      out[k] = dot4(*reinterpret_cast<const float4*>(A + (warp + kWarps * k) * lda + q), bv,
                    out[k]);
  }
}

// acc[k][m] += sum_q A[(warp + 8k) * lda + q] * Bn[q * ldb + lane + 32m]
// for q < k4 (a multiple of 4; A and Bn zero-padded there) and columns <
// width.
template <int MK>
__device__ __forceinline__ void tile_nn(const float* A, int lda, const float* Bn, int ldb,
                                        int k4, int width, int warp, int lane,
                                        float (&acc)[kRows][MK]) {
  for (int q = 0; q < k4; q += 4) {
    float4 av[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      av[k] = *reinterpret_cast<const float4*>(A + (warp + kWarps * k) * lda + q);
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      const int col = lane + 32 * m;
      if (col < width) {
        const float4 bv = make_float4(Bn[q * ldb + col], Bn[(q + 1) * ldb + col],
                                      Bn[(q + 2) * ldb + col], Bn[(q + 3) * ldb + col]);
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k][m] = dot4(av[k], bv, acc[k][m]);
      }
    }
  }
}

// One pass over the chunk of one head.  kPassA: outer column tiles j (B_j,
// xdt_j), inner row tiles i >= j (C_i, dy_i), state g: dxdt_j and dB_j.
// !kPassA: outer row tiles i (C_i, dy_i), inner j <= i (B_j, xdt_j), state
// h: dC_i.  The 32 x 32 tiles are formed with the outer index as row r and
// the inner one as column: S1 = outer_bc . inner_bc^T (G^T in pass A, G in
// pass B) and S2 = outer_x . inner_x^T (dM^T, dM).
template <typename T, bool kPassA, int PK, int NK>
__device__ __forceinline__ void chunk_pass(
    const ChunkSmem& sh, float* cum, float* dcum, float* ws, float* st, float* ob, float* ib,
    float* ox, float* ix, float* m1, float* m2, const float* xb, const float* dyb,
    const T* bb, const T* cb, const float* state, bool has_state, int SR, float* dxb,
    float* dpart, int H, int P, int N, int Q) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const size_t x_stride = static_cast<size_t>(H) * P;
  const int n4 = round4(N);
  const int p4 = round4(P);
  const float total = cum[Q - 1];
  const bool resident = SR >= P;
  const T* o_bc = kPassA ? bb : cb;
  const T* i_bc = kPassA ? cb : bb;
  const float* o_x = kPassA ? xb : dyb;
  const float* i_x = kPassA ? dyb : xb;

  if (has_state && resident) load_state(st, sh.ns, state, 0, P, N);  // read after a barrier

  for (int ot = 0; ot < n_tiles; ++ot) {
    const int o0 = ot * kTile;
    __syncthreads();  // the last tile's readers of ob, ox and st are done
    load_tile(ob, sh.ns, o_bc, N, o0, Q, N);
    load_tile(ox, sh.pp, o_x, x_stride, o0, Q, P);
    __syncthreads();

    // The state terms: t = outer_bc . state^T (g B_j, h C_i) into acc_x,
    // acc_n = outer_x . state (g^T xdt_j, h^T dy_i), u = outer_x . t.
    float acc_x[kRows][PK];
    float acc_n[kRows][NK];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int m = 0; m < PK; ++m) acc_x[k][m] = 0.0f;
#pragma unroll
      for (int m = 0; m < NK; ++m) acc_n[k][m] = 0.0f;
    }
    if (has_state) {
      for (int p0 = 0; p0 < P; p0 += SR) {
        const int rows = min(SR, P - p0);
        if (!resident) {
          if (p0 > 0) __syncthreads();  // the last slab's readers are done
          load_state(st, sh.ns, state, p0, rows, N);
          __syncthreads();
        }
        for (int q = 0; q < n4; q += 4) {
          float4 av[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            av[k] = *reinterpret_cast<const float4*>(ob + (warp + kWarps * k) * sh.ns + q);
#pragma unroll
          for (int m = 0; m < PK; ++m) {
            const int p = lane + 32 * m;
            if (p >= p0 && p < p0 + rows) {
              const float4 sv = *reinterpret_cast<const float4*>(st + (p - p0) * sh.ns + q);
#pragma unroll
              for (int k = 0; k < kRows; ++k) acc_x[k][m] = dot4(av[k], sv, acc_x[k][m]);
            }
          }
        }
        tile_nn<NK>(ox + p0, sh.pp, st, sh.ns, round4(rows), N, warp, lane, acc_n);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = warp + kWarps * k;
      const int o = o0 + r;
      float u = 0.0f;
#pragma unroll
      for (int m = 0; m < PK; ++m) {
        const int p = lane + 32 * m;
        if (p < P) u = fmaf(ox[r * sh.pp + p], acc_x[k][m], u);
      }
      u = warp_sum(u);
      const float scale = has_state && o < Q
                              ? (kPassA ? expf(total - cum[o]) : expf(cum[o]))
                              : 0.0f;
#pragma unroll
      for (int m = 0; m < PK; ++m) acc_x[k][m] = kPassA ? acc_x[k][m] * scale : 0.0f;
#pragma unroll
      for (int m = 0; m < NK; ++m) acc_n[k][m] *= scale;
      if (lane == 0 && o < Q) {
        if (kPassA) {
          ws[o] = scale * u;           // w_j xdt_j . g B_j
          dcum[o] -= scale * u;
        } else {
          dcum[o] += scale * u;        // dy_i . exp(cum_i) h C_i
        }
      }
    }

    // The tiles of the causal half: S1 and S2, L, M, dG; dM o M summed
    // over the inner index.
    float rs[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int it_begin = kPassA ? ot : 0;
    const int it_end = kPassA ? n_tiles : ot + 1;
    for (int it = it_begin; it < it_end; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the last tile's readers of ib, ix, m1, m2 are done
      load_tile(ib, sh.ns, i_bc, N, i0, Q, N);
      load_tile(ix, sh.pp, i_x, x_stride, i0, Q, P);
      __syncthreads();
      float s1[kRows], s2[kRows];
      tile_nt(ob, sh.ns, ib, sh.ns, n4, warp, lane, s1);
      tile_nt(ox, sh.pp, ix, sh.pp, p4, warp, lane, s2);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp + kWarps * k;
        const int o = o0 + r;
        const int q = i0 + lane;
        const int ii = kPassA ? q : o;
        const int jj = kPassA ? o : q;
        const bool in = o < Q && q < Q && jj <= ii;
        const float l = in ? expf(cum[ii] - cum[jj]) : 0.0f;
        const float mv = s1[k] * l;
        const float dg = s2[k] * l;
        if (kPassA) m1[r * kMatLd + lane] = mv;
        m2[r * kMatLd + lane] = dg;
        rs[k] += warp_sum(s2[k] * mv);
      }
      __syncthreads();
      if (kPassA) tile_nn<PK>(m1, kMatLd, ix, sh.pp, kTile, P, warp, lane, acc_x);
      tile_nn<NK>(m2, kMatLd, ib, sh.ns, kTile, N, warp, lane, acc_n);
    }

#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = warp + kWarps * k;
      const int o = o0 + r;
      if (o >= Q) continue;
      if (kPassA) {
        float* drow = dxb + static_cast<size_t>(o) * x_stride;
#pragma unroll
        for (int m = 0; m < PK; ++m) {
          const int p = lane + 32 * m;
          if (p < P) drow[p] = acc_x[k][m];
        }
      }
      float* nrow = dpart + static_cast<size_t>(o) * N;
#pragma unroll
      for (int m = 0; m < NK; ++m) {
        const int n = lane + 32 * m;
        if (n < N) nrow[n] = acc_n[k][m];
      }
      if (lane == 0) dcum[o] += kPassA ? -rs[k] : rs[k];
    }
  }
}

// Block (batch b, chunk c, head h), h fastest, so that neighbouring blocks
// read the same B and C rows.
template <typename T, int PK, int NK>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ dy, const float* __restrict__ hs,
                     const float* __restrict__ gs, float* __restrict__ dx,
                     float* __restrict__ ddA, float* __restrict__ dBp,
                     float* __restrict__ dCp, int S, int H, int P, int N, int Q, int SR) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem sh = chunk_smem(P, N, Q, SR);
  float* cum = smem;                          // [qp]
  float* dcum = cum + sh.qp;                  // [qp]
  float* ws = dcum + sh.qp;                   // [qp]  w_j xdt_j . g B_j
  float* red = ws + sh.qp;                    // [kThreads]
  float* st = red + kThreads;                 // [st_rows][ns]  state or a slab of it
  float* ob = st + sh.st_rows * sh.ns;        // [kTile][ns]  outer B or C rows
  float* ib = ob + kTile * sh.ns;             // [kTile][ns]  inner
  float* ox = ib + kTile * sh.ns;             // [kTile][pp]  outer xdt or dy rows
  float* ix = ox + kTile * sh.pp;             // [kTile][pp]  inner
  float* m1 = ix + kTile * sh.pp;             // [kTile][kMatLd]  M^T
  float* m2 = m1 + kTile * kMatLd;            // [kTile][kMatLd]  dG^T, dG

  const int nc = S / Q;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc;
  const int b = idx / nc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t tok0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t head0 = tok0 * H * P + static_cast<size_t>(h) * P;
  const float* xb = xdt + head0;
  const float* dyb = dy + head0;
  float* dxb = dx + head0;
  const T* bb = Bm + tok0 * N;
  const T* cb = Cm + tok0 * N;
  const size_t state0 = ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
  const bool has_h = c > 0;
  const bool has_g = c + 1 < nc;
  const size_t part0 = ((static_cast<size_t>(b) * H + h) * (static_cast<size_t>(nc) * Q) +
                        static_cast<size_t>(c) * Q) * N;

  for (int i = threadIdx.x; i < sh.qp; i += kThreads) {
    cum[i] = i < Q ? dA[(tok0 + i) * H + h] : 0.0f;
    dcum[i] = 0.0f;
    ws[i] = 0.0f;
  }
  __syncthreads();
  if (warp == 0) warp_scan(cum, Q, lane);
  __syncthreads();

  chunk_pass<T, true, PK, NK>(sh, cum, dcum, ws, st, ob, ib, ox, ix, m1, m2, xb, dyb, bb, cb,
                              has_g ? gs + state0 : nullptr, has_g, SR, dxb, dBp + part0, H,
                              P, N, Q);
  chunk_pass<T, false, PK, NK>(sh, cum, dcum, ws, st, ob, ib, ox, ix, m1, m2, xb, dyb, bb, cb,
                               has_h ? hs + state0 : nullptr, has_h, SR, dxb, dCp + part0, H,
                               P, N, Q);

  // d total = exp(total) <g, h> + sum_j w_j xdt_j . g B_j, into dcum[Q - 1];
  // then ddA is the reverse running sum.  Fixed orders throughout.
  float part = 0.0f;
  if (has_g && has_h) {
    const float* g = gs + state0;
    const float* hh = hs + state0;
    for (int e = threadIdx.x; e < P * N; e += kThreads) part = fmaf(g[e], hh[e], part);
  }
  red[threadIdx.x] = part;
  __syncthreads();  // also: both passes' dcum and ws are written
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (warp == 0) {
    float wsum = 0.0f;
    for (int i = lane; i < Q; i += 32) wsum += ws[i];
    wsum = warp_sum(wsum);
    if (lane == 0) dcum[Q - 1] += expf(cum[Q - 1]) * red[0] + wsum;
    __syncwarp();
    warp_scan_rev(dcum, Q, lane);
    __syncwarp();
    for (int i = lane; i < Q; i += 32) ddA[(tok0 + i) * H + h] = dcum[i];
  }
}

// ---------------------------------------------------------------------------
// 3. dB and dC: the heads' parts summed in order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      T* __restrict__ dB, T* __restrict__ dC, int B, int S, int H, int N) {
  const size_t per_b = static_cast<size_t>(S) * N;
  const size_t total = static_cast<size_t>(B) * per_b;
  const float* src = blockIdx.y ? dCp : dBp;
  T* dst = blockIdx.y ? dC : dB;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t b = e / per_b;
    const float* p = src + b * H * per_b + (e - b * per_b);
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += p[static_cast<size_t>(h) * per_b];
    dst[e] = from_f32<T>(acc);
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

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int PK, int NK>
int launch_chunk(const float* xdt, const float* dA, const T* Bm, const T* Cm, const float* dy,
                 const float* hs, const float* gs, float* dx, float* ddA, float* dBp,
                 float* dCp, int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  // The whole state when it fits beside the tiles at two blocks an SM,
  // else slabs of 32 rows.
  int SR = P;
  if (chunk_smem_floats(P, N, Q, P) * sizeof(float) > kResidentBudget && P > 32) SR = 32;
  const size_t smem = chunk_smem_floats(P, N, Q, SR) * sizeof(float);
  cudaError_t err = allow_smem(ssd_bwd_chunk_kernel<T, PK, NK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * (S / Q) * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_chunk_kernel<T, PK, NK><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, dBp, dCp, S, H, P, N, Q, SR);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* xdt, const float* dA, const void* Bv, const void* Cv,
               const float* dy, float* dx, float* ddA, void* dBv, void* dCv, float* hs,
               float* gs, float* dBp, float* dCp, int B, int S, int H, int P, int N, int Q,
               int device, cudaStream_t stream) {
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  cudaError_t err;
  if (S / Q > 1) {
    const size_t smem =
        sizeof(float) * (((Q + 31) & ~31) + kTile + kTile * 33 + kTile * pad_ld(N));
    err = allow_smem(ssd_bwd_state_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(B) * H * ((P + 31) / 32);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ssd_bwd_state_kernel<T><<<dim3(static_cast<unsigned>(blocks), 2), kThreads, smem, stream>>>(
        xdt, dA, Bm, Cm, dy, hs, gs, S, H, P, N, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ret;
  if (P <= 64 && N <= 128)
    ret = launch_chunk<T, 2, 4>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, dBp, dCp, B, S, H, P, N,
                                Q, stream);
  else if (P <= 64)
    ret = launch_chunk<T, 2, 8>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, dBp, dCp, B, S, H, P, N,
                                Q, stream);
  else if (N <= 128)
    ret = launch_chunk<T, 4, 4>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, dBp, dCp, B, S, H, P, N,
                                Q, stream);
  else
    ret = launch_chunk<T, 4, 8>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, dBp, dCp, B, S, H, P, N,
                                Q, stream);
  if (ret != 0) return ret;
  const long long elems = static_cast<long long>(B) * S * N;
  const long long want = (elems + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count(device);
  ssd_bwd_reduce_kernel<T>
      <<<dim3(static_cast<unsigned>(want < cap ? want : cap), 2), kThreads, 0, stream>>>(
          dBp, dCp, static_cast<T*>(dBv), static_cast<T*>(dCv), B, S, H, N);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int H, int P, int N, int Q) {
  return B <= 0 || S <= 0 || H <= 0 || Q < 1 || Q > kMaxChunk || S % Q != 0 || P < 1 ||
         P > kMaxP || N < 1 || N > kMaxN || static_cast<int64_t>(B) * H > 0x7fffffff;
}

}  // namespace

// The gradient of ssd_scan_launch's y.  xdt, dy, dx [B, S, H, P] and dA,
// ddA [B, S, H] float32; Bm, Cm, dB, dC [B, S, N] (dtype 0: float32, 1:
// bfloat16); all contiguous.  Scratch, float32: hs and gs [B, S / Q, H, P,
// N] (may be null with one chunk), dBp and dCp [B, H, S, N].  Launches on
// `stream` (PyTorch's current stream).  Returns the cudaError_t of the
// launches; 0 means they were queued.
extern "C" int ssd_scan_bwd_launch(const float* xdt, const float* dA, const void* Bm,
                                   const void* Cm, const float* dy, float* dx, float* ddA,
                                   void* dB, void* dC, float* hs, float* gs, float* dBp,
                                   float* dCp, int B, int S, int H, int P, int N, int Q,
                                   int dtype, int device, void* stream) {
  if (bad_shape(B, S, H, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  if (S / Q > 1 && (hs == nullptr || gs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(xdt, dA, Bm, Cm, dy, dx, ddA, dB, dC, hs, gs, dBp, dCp, B, S, H,
                               P, N, Q, device, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(xdt, dA, Bm, Cm, dy, dx, ddA, dB, dC, hs, gs, dBp, dCp,
                                       B, S, H, P, N, Q, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
