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
// B and C are shared by the heads, and dC and dB are linear in each head's
// dG: with D = sum_h dG^h, one causal [Q, Q] float32 matrix per (row,
// chunk), dC = D B and dB = D^T C plus the heads' state terms.  No atomics anywhere: a
// repeated call gives the same bits.  The dtype fixes the body; neither
// falls back to the other.
//
// bf16 B/C, the tensor-core body: `mma.sync.m16n8k16`, bf16 operands and
// float32 sums, on mma_tiles.cuh's primitives.  A float32 operand is split
// into hi = bf16(x) and lo = bf16(x - hi): a product of two float32
// operands is hi.hi + hi.lo + lo.hi, one with a bf16 factor (B or C, exact)
// hi.b + lo.b.  One bf16 rounding of dM's or M^T dy's operands misses the
// float32 bar on ddA and dxdt (tests/test_torch_ssd_bwd_numerics.py, which
// reads kSplitDm and kSplitM).  Four launches:
//
// 1. `ssd_bwd_state_mma_kernel` (only with more than one chunk), the body
//    of ssd_state.cuh that the forward's `ssd_fwd_state_mma_kernel` also
//    runs: one block of 8 warps per (batch, head, 64 state rows) and
//    direction walks the chunks, forward writing the state entering each
//    chunk, backward the gradient of the state leaving it: state <-
//    exp(total) state + (wt o u)^T v, an MMA with K = Q over 32-token slabs
//    (u = xdt or dy, v = B or C) that a 3-deep cp.async ring brings in raw;
//    the A fragments are read from the raw slab, scaled and split.  Float32
//    [B, nc, H, P, N] each.  Where the forward kernel saved its states
//    (autograd through `SsdScan`), only the backward direction runs, on the
//    same body: the gradients are bit-equal to a call that recomputes them.
// 2. `ssd_bwd_chunk_mma_kernel`: one block of 8 warps per (batch, chunk,
//    group of heads), the group sized from the shape and the SM count
//    (mamba2's and zamba2's training shapes: 8 groups of 10 and of 14
//    heads, 128 blocks, one an SM).  G^T = B C^T is formed once per block
//    on the tensor cores (bf16 products, exact) into float32 scratch in
//    fragment order.  Then per head: g and h, split, staged in turn in the
//    shared memory that dy takes next, give g B_t and h C_t for the warp's
//    tokens (dxdt's and dcum's state terms; g B_t is written to dxdt,
//    which the tiles then add to); dy, split, is staged; warp w owns the
//    16-token column tiles w and nT - 1 - w (an equal share of the causal
//    tiles) and walks the row tiles i >= j: dM^T = xdt_j dy_i^T and dxdt_j
//    += M^T dy_i (three terms each), L, M and dG on the fragments (the next
//    tile's G^T in flight; entries above the diagonal are never formed: exp
//    would overflow there), dM o M summed over rows (in the warp) and over
//    columns (per warp, then across warps in order), and dG added to the
//    group's D, kept in shared memory when it fits beside dy (Q = 256, P =
//    64: 136 KB of 223 KB), else in the block's float32 scratch.  ddA is a
//    warp's reverse scan of dcum.  At the end the block writes D twice, in
//    the fragment orders of D and of D^T.
// 3. `ssd_bwd_finish_kernel`: one block of 8 warps per (batch, chunk, 64
//    tokens), output (dC or dB) and part of the heads: dC = D B + (e o dy)
//    h and dB = D^T C + (w o xdt) g, once per (row, chunk): D summed over
//    the groups in order and split (two terms), B and C exact; the heads'
//    state terms as one product with K = H P (three terms), its slabs (one
//    head's 32 rows of P) brought in raw by a 3-deep cp.async ring and
//    split once per block.  Where one block per (row, chunk, 64 tokens) and
//    output would leave SMs idle, the heads are split in two (two blocks an
//    SM); the parts go to float32 scratch.
// 4. `ssd_bwd_reduce_kernel` (the float32 body's): the parts summed in
//    order, rounded once to bf16.
//
// float32 B/C, the CUDA-core body (float32 FMAs from shared memory; the
// tensor cores take float32 only as TF32), three launches:
//
// 1. `ssd_bwd_state_kernel` (only with more than one chunk): one block
//    per (batch, head, 32 rows of P) and direction.  Forward, it walks the
//    chunks in order and writes the state entering each chunk (the
//    float32 forward's state pass, recomputed: that forward saves
//    nothing); backward, it walks them in reverse and
//    writes g, the gradient of the state leaving each chunk.  Float32
//    scratch [B, nc, H, P, N] each.
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
//    beside the tiles at two blocks an SM (64 x 128), else in slabs of 32
//    rows per tile.  G and dM are formed in both passes.
// 3. `ssd_bwd_reduce_kernel`: dB and dC summed over the heads in order
//    (B and C are shared by them), rounded to their type.
//
// What bounds it: at mamba2-2.7b's training shape (8 rows x 512 tokens,
// H = 80, P = 64, N = 128, Q = 256, bf16 B/C) the least work, each product
// once, is ~2.76e10 float32 flops: G, D B and D^T C once per (row, chunk)
// (4.0e8), the causal halves of dM and M^T dy with 8 operations on each
// entry per head (1.11e10), and the four state products and two state
// passes per chunk boundary (1.61e10): 0.41 ms at 67 TFLOP/s.  It moves
// ~0.26 GB (xdt, dy and dxdt at 84 MB each), 77 us at 3.35 TB/s.  The
// operations bound it.  The tensor-core body does that work with bf16
// products, three for each float32 one; what it moves beyond the least
// bytes is xdt and dy read again by the finish kernel, the states (42 MB
// each, written once, read twice) and the groups' D.  What holds it
// (launch/ssd_bwd_sweep.py's ablations): the chunk kernel runs one block of
// 8 warps an SM (its registers and shared memory), and each head's
// staging phases, barriers and the warp's dependent chains of products
// leave the tensor cores idle most of the time.
//
// Any 1 <= Q <= 256 that divides S, P <= 128 and N <= 256 are accepted,
// as the forward takes, by both bodies; Q, P and N are padded with zeros
// to the 16-wide tiles.  Accurate expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "ssd_state.cuh"

namespace {

using ssd_state::warp_scan;

// bf16 body: dM = dy xdt^T and M^T dy with both operands split hi + lo.
constexpr bool kSplitDm = true;
constexpr bool kSplitM = true;

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

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 B/C
// ---------------------------------------------------------------------------

namespace tc = mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;               // chunk and finish kernels: 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kSlab = 32;                     // tokens (or state rows) per staged slab
constexpr int kFinRows = 64;                  // tokens per finish block
constexpr int kGk = 64;                       // columns of N per pass of the G formation
constexpr int kAld = kSlab + 8;               // bf16 per staged A row (finish kernel)
constexpr int kRawA = kSlab + 4;              // floats per raw A row in the finish ring
constexpr int kFinStages = 3;                 // depth of the finish kernel's cp.async ring

using ssd_state::a_addr;
using ssd_state::b_kn_addr;
using ssd_state::b_nk_addr;
using ssd_state::ld_bf16x2;
using ssd_state::ld_f2;
using ssd_state::mma2;
using ssd_state::round16;
using ssd_state::round32;
using ssd_state::split_frag;
using ssd_state::st_f2;
using ssd_state::stage_bf16_rows;

__host__ __device__ __forceinline__ int tri_count(int nt) { return nt * (nt + 1) / 2; }
// Index of the causal 16 x 16 tile (row tile r >= column tile k).
__device__ __forceinline__ int tri_index(int r, int k) { return r * (r + 1) / 2 + k; }

// A float32 16 x 16 tile in fragment order, [2][32 lanes][4]: lane l's
// accumulators of the first n8 half at 4 l, of the second at 128 + 4 l
// (conflict-free float4 accesses).  Position q of a lane's 8 values is row
// g + 8 ((q & 3) >> 1), column 2c + (q & 1) + 8 (q >> 2), lane = 4 g + c;
// the 8 values, paired in order, are also the A fragment of that tile.
__device__ __forceinline__ void load_frag(const float* tile, int lane, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(tile + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(tile + 128 + 4 * lane);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store_frag(float* tile, int lane, const float (&v)[8]) {
  *reinterpret_cast<float4*>(tile + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(tile + 128 + 4 * lane) = make_float4(v[4], v[5], v[6], v[7]);
}
// Element (row r, column k) of a fragment-ordered tile.
__device__ __forceinline__ float frag_at(const float* tile, int r, int k) {
  return tile[(k >> 3) * 128 + (4 * (r & 7) + ((k & 7) >> 1)) * 4 + (r >> 3) * 2 + (k & 1)];
}
// Elements p .. p + 3 of a float32 row of length P; zero past P or when !ok.
__device__ __forceinline__ float4 ld_f4(const float* row, int p, int P, bool ok) {
  if (!ok || p >= P) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if ((P & 3) == 0) return *reinterpret_cast<const float4*>(row + p);
  return make_float4(row[p], p + 1 < P ? row[p + 1] : 0.0f, p + 2 < P ? row[p + 2] : 0.0f,
                     p + 3 < P ? row[p + 3] : 0.0f);
}
// c += (a_hi + a_lo)(b_hi + b_lo) without lo.lo: three products, or one
// of the rounded operands when !kSplit.
template <bool kSplit>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  tc::mma_bf16(c, ah, bh0, bh1);
  if (kSplit) {
    tc::mma_bf16(c, ah, bl0, bl1);
    tc::mma_bf16(c, al, bh0, bh1);
  }
}

// 1. The states entering each chunk and the state gradients leaving it:
// ssd_state.cuh's body, blockIdx.y + rev0 = 0 forward (h_c for c = 1 ..
// nc - 1 into hs), 1 backward (g_c for c = nc - 2 .. 0 into gs).  rev0 = 1
// with one row of blocks runs the backward direction alone, when the
// forward kernel saved its states.
template <int NPW>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_state_mma_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                         const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                         const float* __restrict__ dy, float* __restrict__ hs,
                         float* __restrict__ gs, int S, int H, int P, int N, int Q,
                         int vec_bc, int vec_u, int rev0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ssd_state::state_pass<NPW>(smem_raw, xdt, dA, Bm, Cm, dy, hs, gs, nullptr,
                             blockIdx.y + rev0 == 1, S, H, P, N, Q, vec_bc, vec_u);
}

// 2. One chunk of a group of heads: G once, then per head dxdt, ddA and the
// head's dG added to the group's D.

struct ChunkLayout {
  int qp;     // per-token arrays: Q rounded up to 32 (the warp scans' reach)
  int nt;     // 16-token tiles
  int tiles;  // causal 16 x 16 tiles
  int ldy;    // bf16 per staged dy row
  int ldn;    // bf16 per staged state row
  int stage;  // bf16 of each of the two staging buffers (hi, lo): dy, or state rows
  int sr;     // state rows per staged slab
};

// 16-column tiles of P in the chunk kernel (its template argument).
__host__ __device__ __forceinline__ int p_tiles(int P) {
  return P <= 16 ? 1 : P <= 32 ? 2 : P <= 64 ? 4 : 8;
}

__host__ __device__ __forceinline__ ChunkLayout chunk_layout(int P, int N, int Q) {
  const int nt = round16(Q) / 16;
  const int ldy = 16 * p_tiles(P) + 8;
  const int ldn = round16(N) + 8;
  const int stage = 16 * nt * ldy > 16 * ldn ? 16 * nt * ldy : 16 * ldn;
  const int sr = stage / ldn / 16 * 16;
  return {round32(Q), nt, tri_count(nt), ldy, ldn, stage, sr < round16(P) ? sr : round16(P)};
}

// Shared memory of the chunk kernel, with or without D.
size_t chunk_mma_smem(int P, int N, int Q, bool d_in_smem) {
  const ChunkLayout ly = chunk_layout(P, N, Q);
  return sizeof(float) * (static_cast<size_t>(6 + kTcWarps) * ly.qp + kTcThreads) +
         sizeof(bf16) * 2 * static_cast<size_t>(ly.stage) +
         (d_in_smem ? sizeof(float) * 256 * static_cast<size_t>(ly.tiles) : 0);
}

// out[m] = rows_m state^T for the warp's column tiles m (16 tokens each,
// [16, P] in mma fragments): the state's [P, N] float32 rows staged split
// (hi, lo) in slabs of ly.sr rows into sh and sl, the tiles' B or C rows
// (exact) from global.  Every thread calls it: it stages and synchronises.
template <int PT>
__device__ __forceinline__ void state_product(float (&out)[2][2 * PT][4], const float* state,
                                              const bf16* rows, int n_mine, int jt0, int jt1,
                                              bf16* sh, bf16* sl, const ChunkLayout& ly, int P,
                                              int N, int Q) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int np16 = round16(N);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 2 * PT; ++nt)
      out[m][nt][0] = out[m][nt][1] = out[m][nt][2] = out[m][nt][3] = 0.0f;
  for (int p0 = 0; p0 < P; p0 += ly.sr) {
    const int rows_here = min(ly.sr, round16(P) - p0);
    __syncthreads();  // the staging buffers' last readers are done
#pragma unroll 4
    for (int e = tid; e < rows_here * (np16 / 2); e += kTcThreads) {
      const int r = e / (np16 / 2);
      const int n = 2 * (e - r * (np16 / 2));
      const float2 v = ld_f2(state + static_cast<size_t>(p0 + r) * N, n, N, p0 + r < P);
      uint32_t hi, lo;
      tc::split_bf16(v.x, v.y, hi, lo);
      *reinterpret_cast<uint32_t*>(sh + r * ly.ldn + n) = hi;
      *reinterpret_cast<uint32_t*>(sl + r * ly.ldn + n) = lo;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= n_mine) break;
      const int ja = 16 * (m == 0 ? jt0 : jt1) + g;
#pragma unroll 2
      for (int kn = 0; kn < np16 / 16; ++kn) {
        const int n0 = 16 * kn + 2 * c4;
        const uint32_t a[4] = {ld_bf16x2(rows + ja * N, n0, N, ja < Q),
                               ld_bf16x2(rows + (ja + 8) * N, n0, N, ja + 8 < Q),
                               ld_bf16x2(rows + ja * N, n0 + 8, N, ja < Q),
                               ld_bf16x2(rows + (ja + 8) * N, n0 + 8, N, ja + 8 < Q)};
#pragma unroll
        for (int pp = 0; pp < PT; ++pp) {
          const int pr = 16 * pp - p0;
          if (pr >= 0 && pr < rows_here) {
            uint32_t bh[4], bl[4];
            tc::ldsm_x4(bh, b_nk_addr(sh + pr * ly.ldn + 16 * kn, ly.ldn, lane));
            tc::ldsm_x4(bl, b_nk_addr(sl + pr * ly.ldn + 16 * kn, ly.ldn, lane));
            tc::mma_bf16(out[m][2 * pp], a, bh[0], bh[1]);
            tc::mma_bf16(out[m][2 * pp], a, bl[0], bl[1]);
            tc::mma_bf16(out[m][2 * pp + 1], a, bh[2], bh[3]);
            tc::mma_bf16(out[m][2 * pp + 1], a, bl[2], bl[3]);
          }
        }
      }
    }
  }
}

// Block (batch b, chunk c, heads [h0, h0 + group)), blockIdx.x = (b nc + c)
// n_groups + group index.  Scratch of the block: G^T tiles [tiles][256],
// then D's two copies [2][tiles][256] (D^T's fragments at causal tile
// (i, j), D's), all float32 in fragment order.
template <int PT>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_chunk_mma_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                         const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                         const float* __restrict__ dy, const float* __restrict__ hs,
                         const float* __restrict__ gs, float* __restrict__ dx,
                         float* __restrict__ ddA, float* gsc, float* dsc, float* ewp, int S,
                         int H, int P, int N, int Q, int group, int d_in_smem) {
  constexpr int kPp = 16 * PT;  // P padded to the mma tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ChunkLayout ly = chunk_layout(P, N, Q);
  const int qp = ly.qp;
  const int nT = ly.nt;
  const int T = ly.tiles;
  float* cum = reinterpret_cast<float*>(smem_raw);   // [qp]
  float* ev = cum + qp;                               // [qp]  exp(cum)
  float* wv = ev + qp;                                // [qp]  exp(total - cum)
  float* cs = wv + qp;                                // [qp]  colsum(dM o M)
  float* st = cs + qp;                                // [qp]  state terms of dcum, then dcum
  float* wsv = st + qp;                               // [qp]  w_j xdt_j . g B_j
  float* rs = wsv + qp;                               // [kTcWarps][qp]  rowsum parts
  float* red = rs + kTcWarps * qp;                    // [kTcThreads]
  bf16* dyh = reinterpret_cast<bf16*>(red + kTcThreads);   // [16 nT][ldy] or [sr][ldn]
  bf16* dyl = dyh + ly.stage;                              // the same

  const int nc = S / Q;
  const int n_groups = (H + group - 1) / group;
  int idx = blockIdx.x;
  const int blk = idx;
  const int h0 = (idx % n_groups) * group;
  idx /= n_groups;
  const int c = idx % nc;
  const int b = idx / nc;
  const int gh = min(group, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int np16 = round16(N);
  const size_t tok0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t x_tok = static_cast<size_t>(H) * P;
  const bf16* bsrc = Bm + tok0 * N;
  const bf16* csrc = Cm + tok0 * N;
  const bool has_h = c > 0;
  const bool has_g = c + 1 < nc;
  float* g_tiles = gsc + static_cast<size_t>(blk) * T * 256;
  float* d_tiles = dsc + static_cast<size_t>(blk) * 2 * T * 256;
  float* dacc = d_in_smem ? reinterpret_cast<float*>(dyl + ly.stage) : d_tiles;

  // The warp's column tiles: w and nT - 1 - w (one where they meet).
  const int n_mine = warp < nT - 1 - warp ? 2 : (warp == nT - 1 - warp ? 1 : 0);
  const int jt0 = warp;
  const int jt1 = nT - 1 - warp;

  // G^T = B C^T on the warp's causal tiles (j, i >= j), bf16 products in
  // float32: exact but for the order of the sums.
  for (int m = 0; m < n_mine; ++m) {
    const int jt = m == 0 ? warp : nT - 1 - warp;
    const int ja = 16 * jt + g;
    for (int k0 = 0; k0 < np16; k0 += kGk) {
      uint32_t a[kGk / 16][4];   // B_j's A fragments for kGk columns of N, loaded once
#pragma unroll
      for (int kn = 0; kn < kGk / 16; ++kn) {
        const int n0 = k0 + 16 * kn + 2 * c4;
        a[kn][0] = ld_bf16x2(bsrc + ja * N, n0, N, ja < Q);
        a[kn][1] = ld_bf16x2(bsrc + (ja + 8) * N, n0, N, ja + 8 < Q);
        a[kn][2] = ld_bf16x2(bsrc + ja * N, n0 + 8, N, ja < Q);
        a[kn][3] = ld_bf16x2(bsrc + (ja + 8) * N, n0 + 8, N, ja + 8 < Q);
      }
      for (int it = jt; it < nT; ++it) {
        const int ia = 16 * it + g;
        float v[8];
        if (k0 == 0) {
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = 0.0f;
        } else {
          load_frag(g_tiles + tri_index(it, jt) * 256, lane, v);
        }
        float(&a0)[4] = *reinterpret_cast<float(*)[4]>(v);
        float(&a1)[4] = *reinterpret_cast<float(*)[4]>(v + 4);
        uint32_t bc[kGk / 16][4];
#pragma unroll
        for (int kn = 0; kn < kGk / 16; ++kn) {
          const int n0 = k0 + 16 * kn + 2 * c4;
          bc[kn][0] = ld_bf16x2(csrc + ia * N, n0, N, ia < Q);
          bc[kn][1] = ld_bf16x2(csrc + ia * N, n0 + 8, N, ia < Q);
          bc[kn][2] = ld_bf16x2(csrc + (ia + 8) * N, n0, N, ia + 8 < Q);
          bc[kn][3] = ld_bf16x2(csrc + (ia + 8) * N, n0 + 8, N, ia + 8 < Q);
        }
#pragma unroll
        for (int kn = 0; kn < kGk / 16; ++kn) {
          tc::mma_bf16(a0, a[kn], bc[kn][0], bc[kn][1]);
          tc::mma_bf16(a1, a[kn], bc[kn][2], bc[kn][3]);
        }
        store_frag(g_tiles + tri_index(it, jt) * 256, lane, v);
      }
    }
  }

  for (int hh = 0; hh < gh; ++hh) {
    const int h = h0 + hh;
    const float* xh = xdt + tok0 * x_tok + static_cast<size_t>(h) * P;
    const float* dyg = dy + tok0 * x_tok + static_cast<size_t>(h) * P;
    const size_t state0 = ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
    const float* gst = gs + state0;
    const float* hst = hs + state0;

    __syncthreads();  // the last head's readers of dy, cum and the sums are done
    for (int i = tid; i < qp; i += kTcThreads) {
      cum[i] = i < Q ? dA[(tok0 + i) * H + h] : 0.0f;
      cs[i] = 0.0f;
      st[i] = 0.0f;
      wsv[i] = 0.0f;
    }
    for (int i = tid; i < kTcWarps * qp; i += kTcThreads) rs[i] = 0.0f;
    __syncthreads();
    if (warp == 0) warp_scan(cum, Q, lane);
    __syncthreads();
    const float total = cum[Q - 1];
    for (int i = tid; i < qp; i += kTcThreads) {
      const float e = i < Q ? expf(cum[i]) : 0.0f;
      const float w = i < Q ? expf(total - cum[i]) : 0.0f;
      ev[i] = e;
      wv[i] = w;
      if (i < Q) *reinterpret_cast<float2*>(ewp + 2 * ((tok0 + i) * H + h)) = make_float2(e, w);
    }
    // <g, h> for d total (both states exist only between two chunks).
    float part = 0.0f;
    if (has_g && has_h)
#pragma unroll 4
      for (int e = tid; e < P * N; e += kTcThreads) part = fmaf(gst[e], hst[e], part);
    red[tid] = part;
    __syncthreads();  // also: ev and wv are written
    if (has_g && has_h) {
      for (int s = kTcThreads / 2; s > 0; s >>= 1) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
      }
    }

    // The state terms of the warp's tokens t: g B_t (dxdt starts at
    // w_t g B_t, written to dxdt until the tiles add to it; ws_t = w_t xdt_t .
    // g B_t) and h C_t (dcum gets exp(cum_t) dy_t . h C_t), the state split
    // (two terms).
    float* dxh = dx + tok0 * x_tok + static_cast<size_t>(h) * P;
    if (has_g) {
      float sb[2][2 * PT][4];
      state_product<PT>(sb, gst, bsrc, n_mine, jt0, jt1, dyh, dyl, ly, P, N, Q);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m >= n_mine) break;
        const int ja = 16 * (m == 0 ? jt0 : jt1) + g;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 2 * PT; ++nt) {
          const int p = 8 * nt + 2 * c4;
          const float2 x0 = ld_f2(xh + ja * x_tok, p, P, ja < Q);
          const float2 x1 = ld_f2(xh + (ja + 8) * x_tok, p, P, ja + 8 < Q);
          s0 = fmaf(x0.x, sb[m][nt][0], fmaf(x0.y, sb[m][nt][1], s0));
          s1 = fmaf(x1.x, sb[m][nt][2], fmaf(x1.y, sb[m][nt][3], s1));
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        const float w0 = wv[ja];
        const float w1 = wv[ja + 8];
        if (c4 == 0) {
          wsv[ja] = w0 * s0;
          wsv[ja + 8] = w1 * s1;
          st[ja] -= w0 * s0;
          st[ja + 8] -= w1 * s1;
        }
#pragma unroll
        for (int nt = 0; nt < 2 * PT; ++nt) {
          const int p = 8 * nt + 2 * c4;
          if (ja < Q) st_f2(dxh + ja * x_tok, p, P, w0 * sb[m][nt][0], w0 * sb[m][nt][1]);
          if (ja + 8 < Q)
            st_f2(dxh + (ja + 8) * x_tok, p, P, w1 * sb[m][nt][2], w1 * sb[m][nt][3]);
        }
      }
    }
    if (has_h) {
      float sc[2][2 * PT][4];
      state_product<PT>(sc, hst, csrc, n_mine, jt0, jt1, dyh, dyl, ly, P, N, Q);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m >= n_mine) break;
        const int ja = 16 * (m == 0 ? jt0 : jt1) + g;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 2 * PT; ++nt) {
          const int p = 8 * nt + 2 * c4;
          const float2 y0 = ld_f2(dyg + ja * x_tok, p, P, ja < Q);
          const float2 y1 = ld_f2(dyg + (ja + 8) * x_tok, p, P, ja + 8 < Q);
          s0 = fmaf(y0.x, sc[m][nt][0], fmaf(y0.y, sc[m][nt][1], s0));
          s1 = fmaf(y1.x, sc[m][nt][2], fmaf(y1.y, sc[m][nt][3], s1));
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (c4 == 0) {
          st[ja] += ev[ja] * s0;
          st[ja + 8] += ev[ja + 8] * s1;
        }
      }
    }

    __syncthreads();  // the staged state's readers are done
#pragma unroll 4
    for (int e = tid; e < 16 * nT * (kPp / 4); e += kTcThreads) {
      const int r = e / (kPp / 4);
      const int p = 4 * (e - r * (kPp / 4));
      const float4 v = ld_f4(dyg + r * x_tok, p, P, r < Q);
      uint32_t h01, l01, h23, l23;
      tc::split_bf16(v.x, v.y, h01, l01);
      tc::split_bf16(v.z, v.w, h23, l23);
      *reinterpret_cast<uint2*>(dyh + r * ly.ldy + p) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(dyl + r * ly.ldy + p) = make_uint2(l01, l23);
    }
    __syncthreads();

    for (int m = 0; m < n_mine; ++m) {
      const int jt = m == 0 ? jt0 : jt1;
      const int j0 = 16 * jt;
      const int ja = j0 + g;          // this thread's rows ja, ja + 8
      float acc[2 * PT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

      if (has_g) {
#pragma unroll
        for (int nt = 0; nt < 2 * PT; ++nt) {
          const int p = 8 * nt + 2 * c4;
          const float2 v0 = ld_f2(dxh + ja * x_tok, p, P, ja < Q);
          const float2 v1 = ld_f2(dxh + (ja + 8) * x_tok, p, P, ja + 8 < Q);
          acc[nt][0] = v0.x;
          acc[nt][1] = v0.y;
          acc[nt][2] = v1.x;
          acc[nt][3] = v1.y;
        }
      }

      // xdt_j as the A fragments of dM^T = xdt_j dy_i^T, split.
      uint32_t xa_h[PT][4], xa_l[PT][4];
#pragma unroll
      for (int kk = 0; kk < PT; ++kk) {
        const int p = 16 * kk + 2 * c4;
        const float2 v0 = ld_f2(xh + ja * x_tok, p, P, ja < Q);
        const float2 v1 = ld_f2(xh + (ja + 8) * x_tok, p, P, ja + 8 < Q);
        const float2 v2 = ld_f2(xh + ja * x_tok, p + 8, P, ja < Q);
        const float2 v3 = ld_f2(xh + (ja + 8) * x_tok, p + 8, P, ja + 8 < Q);
        tc::split_bf16(v0.x, v0.y, xa_h[kk][0], xa_l[kk][0]);
        tc::split_bf16(v1.x, v1.y, xa_h[kk][1], xa_l[kk][1]);
        tc::split_bf16(v2.x, v2.y, xa_h[kk][2], xa_l[kk][2]);
        tc::split_bf16(v3.x, v3.y, xa_h[kk][3], xa_l[kk][3]);
      }
      const float cum_a = cum[ja];
      const float cum_b = cum[ja + 8];
      float col_a = 0.0f, col_b = 0.0f;   // colsum(dM o M) of rows ja, ja + 8

      float gt[8];
      load_frag(g_tiles + tri_index(jt, jt) * 256, lane, gt);
      for (int it = jt; it < nT; ++it) {
        const int i0 = 16 * it;
        float g_next[8];   // the next tile's G^T, in flight during this one
        if (it + 1 < nT) load_frag(g_tiles + tri_index(it + 1, jt) * 256, lane, g_next);
        float dm[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float(&dm0)[4] = *reinterpret_cast<float(*)[4]>(dm);
        float(&dm1)[4] = *reinterpret_cast<float(*)[4]>(dm + 4);
#pragma unroll
        for (int kk = 0; kk < PT; ++kk) {
          uint32_t bh[4], bl[4];
          tc::ldsm_x4(bh, b_nk_addr(dyh + i0 * ly.ldy + 16 * kk, ly.ldy, lane));
          tc::ldsm_x4(bl, b_nk_addr(dyl + i0 * ly.ldy + 16 * kk, ly.ldy, lane));
          mma3<kSplitDm>(dm0, xa_h[kk], xa_l[kk], bh[0], bh[1], bl[0], bl[1]);
          mma3<kSplitDm>(dm1, xa_h[kk], xa_l[kk], bh[2], bh[3], bl[2], bl[3]);
        }
        // L, M, dG and dM o M on the fragments; nothing above the diagonal.
        float mt[8], dg[8], pm[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = ja + 8 * ((q & 3) >> 1);
          const int i = i0 + 2 * c4 + (q & 1) + 8 * (q >> 2);
          const float l = (j <= i && i < Q) ? expf(cum[i] - ((q & 2) ? cum_b : cum_a)) : 0.0f;
          mt[q] = gt[q] * l;
          dg[q] = dm[q] * l;
          pm[q] = dm[q] * mt[q];
        }
        col_a += (pm[0] + pm[1]) + (pm[4] + pm[5]);
        col_b += (pm[2] + pm[3]) + (pm[6] + pm[7]);
        float rcol[4] = {pm[0] + pm[2], pm[1] + pm[3], pm[4] + pm[6], pm[5] + pm[7]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rcol[k] += __shfl_xor_sync(0xffffffffu, rcol[k], 4);
          rcol[k] += __shfl_xor_sync(0xffffffffu, rcol[k], 8);
          rcol[k] += __shfl_xor_sync(0xffffffffu, rcol[k], 16);
        }
        if (g == 0) {
          float* rw = rs + warp * qp + i0 + 2 * c4;
          rw[0] += rcol[0];
          rw[1] += rcol[1];
          rw[8] += rcol[2];
          rw[9] += rcol[3];
        }
        // D += dG^T on this tile, heads in order.
        float* dt = dacc + tri_index(it, jt) * 256;
        if (hh > 0) {
          float prev[8];
          load_frag(dt, lane, prev);
#pragma unroll
          for (int q = 0; q < 8; ++q) dg[q] = prev[q] + dg[q];
        }
        store_frag(dt, lane, dg);
        // dxdt_j += M^T dy_i: M^T's accumulators are its A fragments.
        uint32_t mh[4], ml[4];
        split_frag(mt, mh, ml);
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          uint32_t bh[4], bl[4];
          tc::ldsm_x4_trans(bh, b_kn_addr(dyh + i0 * ly.ldy + 16 * dp, ly.ldy, lane));
          tc::ldsm_x4_trans(bl, b_kn_addr(dyl + i0 * ly.ldy + 16 * dp, ly.ldy, lane));
          mma3<kSplitM>(acc[2 * dp], mh, ml, bh[0], bh[1], bl[0], bl[1]);
          mma3<kSplitM>(acc[2 * dp + 1], mh, ml, bh[2], bh[3], bl[2], bl[3]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) gt[q] = g_next[q];
      }

#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) {
        const int p = 8 * nt + 2 * c4;
        if (ja < Q) st_f2(dxh + ja * x_tok, p, P, acc[nt][0], acc[nt][1]);
        if (ja + 8 < Q) st_f2(dxh + (ja + 8) * x_tok, p, P, acc[nt][2], acc[nt][3]);
      }
      col_a += __shfl_xor_sync(0xffffffffu, col_a, 1);
      col_a += __shfl_xor_sync(0xffffffffu, col_a, 2);
      col_b += __shfl_xor_sync(0xffffffffu, col_b, 1);
      col_b += __shfl_xor_sync(0xffffffffu, col_b, 2);
      if (c4 == 0) {
        cs[ja] = col_a;
        cs[ja + 8] = col_b;
      }
    }

    // dcum = the warps' rowsums in order - colsum + the state terms; the
    // last entry's d total; ddA is its reverse running sum.
    __syncthreads();
    for (int i = tid; i < qp; i += kTcThreads) {
      float v = 0.0f;
      if (i < Q) {
        float r = 0.0f;
#pragma unroll
        for (int w = 0; w < kTcWarps; ++w) r += rs[w * qp + i];
        v = r - cs[i] + st[i];
      }
      st[i] = v;
    }
    __syncthreads();
    if (warp == 0) {
      float wsum = 0.0f;
      for (int i = lane; i < Q; i += 32) wsum += wsv[i];
      wsum = warp_sum(wsum);
      __syncwarp();
      if (lane == 0) st[Q - 1] += expf(total) * red[0] + wsum;
      __syncwarp();
      warp_scan_rev(st, Q, lane);
      __syncwarp();
      for (int i = lane; i < Q; i += 32) ddA[(tok0 + i) * H + h] = st[i];
    }
  }

  // D's two copies: D^T's fragments as accumulated (when D sat in shared
  // memory), and D's, read transposed from them.
  for (int m = 0; m < n_mine; ++m) {
    const int jt = m == 0 ? warp : nT - 1 - warp;
    for (int it = jt; it < nT; ++it) {
      const float* src = dacc + tri_index(it, jt) * 256;
      float v[8];
      if (d_in_smem) {
        load_frag(src, lane, v);
        store_frag(d_tiles + tri_index(it, jt) * 256, lane, v);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = frag_at(src, 2 * c4 + (q & 1) + 8 * (q >> 2), g + 8 * ((q & 3) >> 1));
      store_frag(d_tiles + (T + tri_index(it, jt)) * 256, lane, v);
    }
  }
}

// 3. dC = D B + (e o dy) h and dB = D^T C + (w o xdt) g, once per (row,
// chunk).
//
// Block (batch b, chunk c, tokens [64 rt, 64 rt + 64)), blockIdx.y = 0: dC,
// 1: dB.  Warp w owns the block's 16-token tile w & 3 and half the
// 16-column pairs of N.  The K loop walks 32-wide slabs: first the causal
// token tiles of D (A: the groups' D tiles summed in order from scratch and
// split; B: B or C rows, exact), then the K = H P rows of the states (A:
// dy or xdt scaled by exp(cum) or w per head, B: h or g, both split).
// Floats of one stage of the finish kernel's ring: raw A [kFinRows][kRawA],
// state rows [kSlab][N + 4], the rows' scales [kFinRows].
__host__ __device__ __forceinline__ int finish_ring_floats(int N) {
  return kFinRows * kRawA + kSlab * (round16(N) + 4) + kFinRows;
}

size_t finish_smem(int N) {
  const int ldv = round16(N) + 8;
  return sizeof(float) * kFinStages * static_cast<size_t>(finish_ring_floats(N)) +
         sizeof(bf16) * (3 * kSlab * ldv + 2 * kFinRows * kAld);
}

template <int NPW>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_finish_kernel(const float* __restrict__ xdt, const float* __restrict__ dy,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const float* __restrict__ hs, const float* __restrict__ gs,
                      const float* dsc, const float* ewp, float* __restrict__ parts, int S,
                      int H, int P, int N, int Q, int n_groups, int vec_bc, int vec_a,
                      int vec_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np16 = round16(N);
  const int ldv = np16 + 8;
  const int ring_floats = finish_ring_floats(N);
  float* ring = reinterpret_cast<float*>(smem_raw);   // [kFinStages][ring_floats]
  bf16* vs = reinterpret_cast<bf16*>(ring + kFinStages * ring_floats);   // [kSlab][ldv] B, C
  bf16* bh = vs + kSlab * ldv;                     // [kSlab][ldv]  state rows, hi
  bf16* bl = bh + kSlab * ldv;                     // [kSlab][ldv]  lo
  bf16* ah = bl + kSlab * ldv;                     // [kFinRows][kAld]
  bf16* al = ah + kFinRows * kAld;                 // [kFinRows][kAld]

  const bool is_db = blockIdx.y == 1;
  const int split = blockIdx.z;                     // this block's part of the heads
  const int n_split = gridDim.z;
  const int nc = S / Q;
  const int n_rt = (Q + kFinRows - 1) / kFinRows;
  int idx = blockIdx.x;
  const int rt = idx % n_rt;
  idx /= n_rt;
  const int c = idx % nc;
  const int b = idx / nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int nT = round16(Q) / 16;
  const int T = tri_count(nT);
  const int my_tile = 4 * rt + (warp & 3);
  const bool live = my_tile < nT;
  const int pairs = np16 / 16;
  const int ppw = (pairs + 1) / 2;
  const int pbeg = (warp >> 2) * ppw;
  const int pend = min(pairs, pbeg + ppw);
  const size_t tok0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t blk0 = (static_cast<size_t>(b) * nc + c) * n_groups;

  float acc[NPW][2][4];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][hf][k] = 0.0f;

  // D's part: dC's k runs over tiles <= the row tile, dB's over tiles >= it.
  const bf16* vsrc = (is_db ? Cm : Bm) + tok0 * N;
  const int kt_begin = is_db ? 4 * rt : 0;
  const int kt_end = split > 0 ? kt_begin : (is_db ? nT : min(nT, 4 * rt + 4));
  for (int kt0 = kt_begin; kt0 < kt_end; kt0 += 2) {
    __syncthreads();  // the last slab's readers of vs are done
    stage_bf16_rows(vs, ldv, vsrc, 16 * kt0, kSlab, Q, N, np16, vec_bc, tid, kTcThreads);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kt = kt0 + kk;
      if (kt >= kt_end || (is_db ? kt < my_tile : kt > my_tile)) continue;
      const int ti = is_db ? tri_index(kt, my_tile) : tri_index(my_tile, kt);
      float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int gi = 0; gi < n_groups; ++gi) {
        float part[8];
        load_frag(dsc + ((blk0 + gi) * 2 * T + (is_db ? 0 : T) + ti) * 256, lane, part);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] += part[q];
      }
      uint32_t dh[4], dl[4];
      split_frag(v, dh, dl);
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int np = pbeg + i;
        if (np < pend) {
          uint32_t bk[4];
          tc::ldsm_x4_trans(bk, b_kn_addr(vs + 16 * kk * ldv + 16 * np, ldv, lane));
          mma2(acc[i][0], dh, dl, bk[0], bk[1]);
          mma2(acc[i][1], dh, dl, bk[2], bk[3]);
        }
      }
    }
  }

  // The heads' state terms: K = H P rows of h (dC) or g (dB), in slabs of
  // one head's 32 rows of P, each row of A scaled by exp(cum) or w of that
  // head.  Raw float32 slabs of A, of the state rows and of the scales come
  // in through a kFinStages-deep cp.async ring; each slab is split (hi, lo)
  // into the bf16 buffers the fragments are read from.
  if (is_db ? c + 1 < nc : c > 0) {
    const int K = H * P;
    const int ps_n = (P + kSlab - 1) / kSlab;
    const int s_begin = split * H / n_split * ps_n;
    const int n_slabs = (split + 1) * H / n_split * ps_n - s_begin;
    const float* asrc = (is_db ? xdt : dy) + tok0 * K;
    const float* ssrc = (is_db ? gs : hs) + (static_cast<size_t>(b) * nc + c) * K * N;
    const float* ew = ewp + 2 * tok0 * H + (is_db ? 1 : 0);
    const int ldr = np16 + 4;
    const int t_base = kFinRows * rt;
    auto fetch = [&](int s) {
      float* ra = ring + (s % kFinStages) * ring_floats;
      float* rb = ra + kFinRows * kRawA;
      float* rsc = rb + kSlab * ldr;
      const int h = (s_begin + s) / ps_n;
      const int ps = kSlab * (s_begin + s - h * ps_n);
      for (int e = tid; e < kFinRows * (kSlab / 4); e += kTcThreads) {
        const int r = e / (kSlab / 4);
        const int p = ps + 4 * (e - r * (kSlab / 4));
        const int t = t_base + r;
        const float* src = asrc + static_cast<size_t>(t) * K + static_cast<size_t>(h) * P + p;
        const uint32_t dst = tc::smem_addr(ra + r * kRawA + p - ps);
        if (vec_a) {
          const bool in = t < Q && p < P;
          tc::cp_async16(dst, in ? src : asrc, in);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = t < Q && p + u < P;
            tc::cp_async4(dst + 4 * u, in ? src + u : asrc, in);
          }
        }
      }
      for (int e = tid; e < kSlab * (np16 / 4); e += kTcThreads) {
        const int r = e / (np16 / 4);
        const int n = 4 * (e - r * (np16 / 4));
        const bool row = ps + r < P;
        const float* src = ssrc + (static_cast<size_t>(h) * P + ps + r) * N + n;
        const uint32_t dst = tc::smem_addr(rb + r * ldr + n);
        if (vec_s) {
          const bool in = row && n < N;
          tc::cp_async16(dst, in ? src : ssrc, in);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = row && n + u < N;
            tc::cp_async4(dst + 4 * u, in ? src + u : ssrc, in);
          }
        }
      }
      if (tid < kFinRows) {
        const int t = t_base + tid;
        const bool in = t < Q;
        tc::cp_async4(tc::smem_addr(rsc + tid), in ? ew + 2 * (static_cast<size_t>(t) * H + h) : ew,
                      in);
      }
    };
#pragma unroll
    for (int s = 0; s < kFinStages - 1; ++s) {
      if (s < n_slabs) fetch(s);
      tc::cp_async_commit();
    }
    const int ar = tid >> 2;            // the A row and 8 columns this thread splits
    const int ak = (tid & 3) * 8;
    for (int s = 0; s < n_slabs; ++s) {
      tc::cp_async_wait<kFinStages - 2>();
      __syncthreads();  // slab s is in; the last slab's fragment readers are done
      {
        const float* ra = ring + (s % kFinStages) * ring_floats;
        const float* rb = ra + kFinRows * kRawA;
        const float* rsc = rb + kSlab * ldr;
        const float scale = rsc[ar];
#pragma unroll
        for (int u = 0; u < 8; u += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ra + ar * kRawA + ak + u);
          uint32_t h01, l01, h23, l23;
          tc::split_bf16(v.x * scale, v.y * scale, h01, l01);
          tc::split_bf16(v.z * scale, v.w * scale, h23, l23);
          *reinterpret_cast<uint2*>(ah + ar * kAld + ak + u) = make_uint2(h01, h23);
          *reinterpret_cast<uint2*>(al + ar * kAld + ak + u) = make_uint2(l01, l23);
        }
        for (int e = tid; e < kSlab * (np16 / 4); e += kTcThreads) {
          const int r = e / (np16 / 4);
          const int n = 4 * (e - r * (np16 / 4));
          const float4 v = *reinterpret_cast<const float4*>(rb + r * ldr + n);
          uint32_t h01, l01, h23, l23;
          tc::split_bf16(v.x, v.y, h01, l01);
          tc::split_bf16(v.z, v.w, h23, l23);
          *reinterpret_cast<uint2*>(bh + r * ldv + n) = make_uint2(h01, h23);
          *reinterpret_cast<uint2*>(bl + r * ldv + n) = make_uint2(l01, l23);
        }
      }
      if (s + kFinStages - 1 < n_slabs) fetch(s + kFinStages - 1);
      tc::cp_async_commit();
      __syncthreads();  // the split slab is in
      if (!live) continue;
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        uint32_t xh[4], xl[4];
        tc::ldsm_x4(xh, a_addr(ah + 16 * (warp & 3) * kAld + 16 * kk, kAld, lane));
        tc::ldsm_x4(xl, a_addr(al + 16 * (warp & 3) * kAld + 16 * kk, kAld, lane));
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          const int np = pbeg + i;
          if (np < pend) {
            uint32_t sh[4], sl[4];
            tc::ldsm_x4_trans(sh, b_kn_addr(bh + 16 * kk * ldv + 16 * np, ldv, lane));
            tc::ldsm_x4_trans(sl, b_kn_addr(bl + 16 * kk * ldv + 16 * np, ldv, lane));
            mma3<true>(acc[i][0], xh, xl, sh[0], sh[1], sl[0], sl[1]);
            mma3<true>(acc[i][1], xh, xl, sh[2], sh[3], sl[2], sl[3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
  }

  if (!live) return;
  const size_t rows = gridDim.x / (nc * n_rt);       // B
  float* out = parts + ((is_db * rows + b) * n_split + split) * static_cast<size_t>(S) * N +
               static_cast<size_t>(c) * Q * N;
#pragma unroll
  for (int i = 0; i < NPW; ++i) {
    const int np = pbeg + i;
    if (np >= pend) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = 16 * np + 8 * hf + 2 * c4;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = 16 * my_tile + g + 8 * rr;
        if (t < Q) st_f2(out + static_cast<size_t>(t) * N, n, N, acc[i][hf][2 * rr],
                         acc[i][hf][2 * rr + 1]);
      }
    }
  }
}

// Heads per chunk-kernel block: as many groups per (row, chunk) as the
// card has SMs for one block each, at least one head per group.
int bwd_heads_per_block(int B, int S, int H, int Q, int device) {
  const long long rows = static_cast<long long>(B) * (S / Q);
  long long groups = sm_count(device) / rows;
  if (groups < 1) groups = 1;
  if (groups > H) groups = H;
  return static_cast<int>((H + groups - 1) / groups);
}

struct Bf16Plan {
  int group, n_groups;
  long long blocks;        // chunk-kernel blocks
  size_t tiles;            // causal tiles per block
  bool d_in_smem;
  long long fin_blocks;    // finish-kernel blocks per output and part of the heads
  int split;               // parts of the heads the finish kernel's blocks take
};

int max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    bytes = 232448;
  return bytes;
}

Bf16Plan bf16_plan(int B, int S, int H, int P, int N, int Q, int device) {
  Bf16Plan plan;
  plan.group = bwd_heads_per_block(B, S, H, Q, device);
  plan.n_groups = (H + plan.group - 1) / plan.group;
  plan.blocks = static_cast<long long>(B) * (S / Q) * plan.n_groups;
  plan.tiles = static_cast<size_t>(chunk_layout(P, N, Q).tiles);
  plan.d_in_smem = chunk_mma_smem(P, N, Q, true) <= static_cast<size_t>(max_smem(device));
  // The finish kernel's two outputs take one block each per (row, chunk,
  // 64 tokens); where that is under one block an SM, the heads' state
  // terms are split in two, so that two blocks share an SM.
  plan.fin_blocks = static_cast<long long>(B) * (S / Q) * ((Q + kFinRows - 1) / kFinRows);
  plan.split = 2 * plan.fin_blocks < sm_count(device) && H > 1 ? 2 : 1;
  return plan;
}

// Float32 scratch of the bf16 body beside the states: G^T and D's two
// copies per chunk-kernel block, exp(cum) and w per (token, head), then
// the finish kernel's parts of dB and dC [2][B][split][S][N].
long long bf16_scratch_floats(int B, int S, int H, int P, int N, int Q, int device) {
  const Bf16Plan plan = bf16_plan(B, S, H, P, N, Q, device);
  return plan.blocks * 3 * static_cast<long long>(plan.tiles) * 256 + 2LL * B * S * H +
         2LL * B * plan.split * S * N;
}

template <typename F>
cudaError_t max_carveout(F* kernel, size_t bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int PT>
int launch_chunk_mma(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm,
                     const float* dy, const float* hs, const float* gs, float* dx, float* ddA,
                     float* gsc, float* dsc, float* ewp, int S, int H, int P, int N, int Q,
                     const Bf16Plan& plan, cudaStream_t stream) {
  const size_t smem = chunk_mma_smem(P, N, Q, plan.d_in_smem);
  cudaError_t err = max_carveout(ssd_bwd_chunk_mma_kernel<PT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_mma_kernel<PT><<<static_cast<unsigned>(plan.blocks), kTcThreads, smem, stream>>>(
      xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, gsc, dsc, ewp, S, H, P, N, Q, plan.group,
      plan.d_in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The state kernel, both directions, or the backward's alone when the
// forward's states are given (`hs_given`).
cudaError_t launch_state(const float* xdt, const float* dA, const bf16* Bm, const bf16* Cm,
                         const float* dy, float* hs, float* gs, int S, int H, int P, int N,
                         int Q, long long blocks, int vec_bc, int vec_u, int hs_given,
                         cudaStream_t stream) {
  return ssd_state::with_npw(N, [&](auto npw) {
    constexpr int NPW = decltype(npw)::value;
    const size_t smem = ssd_state::state_smem_bytes(N, Q);
    cudaError_t err = allow_smem(ssd_bwd_state_mma_kernel<NPW>, smem);
    if (err != cudaSuccess) return err;
    ssd_bwd_state_mma_kernel<NPW>
        <<<dim3(static_cast<unsigned>(blocks), hs_given ? 1 : 2), kTcThreads, smem, stream>>>(
            xdt, dA, Bm, Cm, dy, hs, gs, S, H, P, N, Q, vec_bc, vec_u, hs_given ? 1 : 0);
    return cudaGetLastError();
  });
}

template <int NPW>
int launch_finish(const float* xdt, const float* dy, const bf16* Bm, const bf16* Cm,
                  const float* hs, const float* gs, const float* dsc, const float* ewp,
                  float* parts, int S, int H, int P, int N, int Q, const Bf16Plan& plan,
                  int vec_bc, cudaStream_t stream) {
  const size_t smem = finish_smem(N);
  cudaError_t err = max_carveout(ssd_bwd_finish_kernel<NPW>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_a = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int vec_s = N % 4 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(gs) % 16 == 0;
  ssd_bwd_finish_kernel<NPW>
      <<<dim3(static_cast<unsigned>(plan.fin_blocks), 2, plan.split), kTcThreads, smem, stream>>>(
          xdt, dy, Bm, Cm, hs, gs, dsc, ewp, parts, S, H, P, N, Q, plan.n_groups, vec_bc, vec_a,
          vec_s);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_bf16(const float* xdt, const float* dA, const void* Bv, const void* Cv,
                    const float* dy, float* dx, float* ddA, void* dBv, void* dCv, float* hs,
                    float* gs, float* scratch, int B, int S, int H, int P, int N, int Q,
                    int hs_given, int device, cudaStream_t stream) {
  const bf16* Bm = static_cast<const bf16*>(Bv);
  const bf16* Cm = static_cast<const bf16*>(Cv);
  const int vec_bc = N % 8 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const Bf16Plan plan = bf16_plan(B, S, H, P, N, Q, device);
  if (plan.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int ppw = (round16(N) / 16 + 1) / 2;   // 16-column pairs per warp (finish)
  if (S / Q > 1) {
    const long long blocks = static_cast<long long>(B) * H * ((P + 63) / 64);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int vec_u = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    err = launch_state(xdt, dA, Bm, Cm, dy, hs, gs, S, H, P, N, Q, blocks, vec_bc, vec_u,
                       hs_given, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* gsc = scratch;
  float* dsc = gsc + plan.blocks * plan.tiles * 256;
  float* ewp = dsc + plan.blocks * 2 * plan.tiles * 256;
  int ret;
  if (P <= 16)
    ret = launch_chunk_mma<1>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, gsc, dsc, ewp, S, H, P, N, Q,
                              plan, stream);
  else if (P <= 32)
    ret = launch_chunk_mma<2>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, gsc, dsc, ewp, S, H, P, N, Q,
                              plan, stream);
  else if (P <= 64)
    ret = launch_chunk_mma<4>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, gsc, dsc, ewp, S, H, P, N, Q,
                              plan, stream);
  else
    ret = launch_chunk_mma<8>(xdt, dA, Bm, Cm, dy, hs, gs, dx, ddA, gsc, dsc, ewp, S, H, P, N, Q,
                              plan, stream);
  if (ret != 0) return ret;
  float* parts = ewp + 2LL * B * S * H;
  if (ppw <= 1)
    ret = launch_finish<1>(xdt, dy, Bm, Cm, hs, gs, dsc, ewp, parts, S, H, P, N, Q, plan, vec_bc,
                           stream);
  else if (ppw <= 2)
    ret = launch_finish<2>(xdt, dy, Bm, Cm, hs, gs, dsc, ewp, parts, S, H, P, N, Q, plan, vec_bc,
                           stream);
  else if (ppw <= 4)
    ret = launch_finish<4>(xdt, dy, Bm, Cm, hs, gs, dsc, ewp, parts, S, H, P, N, Q, plan, vec_bc,
                           stream);
  else
    ret = launch_finish<8>(xdt, dy, Bm, Cm, hs, gs, dsc, ewp, parts, S, H, P, N, Q, plan, vec_bc,
                           stream);
  if (ret != 0) return ret;
  // dB and dC: the parts summed in order and rounded once to bf16 (the
  // finish kernel's output 0 is dC, 1 is dB).
  const long long elems = static_cast<long long>(B) * S * N;
  const long long want = (elems + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count(device);
  ssd_bwd_reduce_kernel<bf16>
      <<<dim3(static_cast<unsigned>(want < cap ? want : cap), 2), kThreads, 0, stream>>>(
          parts + static_cast<size_t>(B) * plan.split * S * N, parts, static_cast<bf16*>(dBv),
          static_cast<bf16*>(dCv), B, S, plan.split, N);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int H, int P, int N, int Q) {
  return B <= 0 || S <= 0 || H <= 0 || Q < 1 || Q > kMaxChunk || S % Q != 0 || P < 1 ||
         P > kMaxP || N < 1 || N > kMaxN || static_cast<int64_t>(B) * H > 0x7fffffff;
}

}  // namespace

// Float32 scratch that ssd_scan_bwd_launch needs beside the states (dtype
// 0: the heads' dB and dC parts [2, B, H, S, N]; 1: the tensor-core body's
// G^T and D tiles and exp(cum), w), or -1 for a shape it refuses.
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int S, int H, int P, int N, int Q,
                                                 int dtype, int device) {
  if (bad_shape(B, S, H, P, N, Q)) return -1;
  if (dtype == 0) return 2LL * B * H * S * N;
  if (dtype == 1) return bf16_scratch_floats(B, S, H, P, N, Q, device);
  return -1;
}

// Heads per chunk-kernel block of the tensor-core body (bf16 B/C) at this
// shape on `device`; -1 for a shape it refuses.
extern "C" int ssd_scan_bwd_heads_per_block(int B, int S, int H, int P, int N, int Q,
                                            int device) {
  if (bad_shape(B, S, H, P, N, Q)) return -1;
  return bwd_heads_per_block(B, S, H, Q, device);
}

// The gradient of ssd_scan_launch's y.  xdt, dy, dx [B, S, H, P] and dA,
// ddA [B, S, H] float32; Bm, Cm, dB, dC [B, S, N] (dtype 0: float32, 1:
// bfloat16); all contiguous.  Float32 hs and gs [B, S / Q, H, P, N] (may
// be null with one chunk): scratch, or with `hs_given` (bf16 only) hs holds
// the states entering chunks 1 .. nc - 1 as ssd_scan_launch's `states`
// leaves them, and only the state gradients are computed.  `scratch` of
// ssd_scan_bwd_scratch_floats floats.  Launches on `stream` (PyTorch's
// current stream).  Returns the cudaError_t of the launches; 0 means they
// were queued.
extern "C" int ssd_scan_bwd_launch(const float* xdt, const float* dA, const void* Bm,
                                   const void* Cm, const float* dy, float* dx, float* ddA,
                                   void* dB, void* dC, float* hs, float* gs, float* scratch,
                                   int B, int S, int H, int P, int N, int Q, int hs_given,
                                   int dtype, int device, void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || scratch == nullptr || (hs_given && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S / Q > 1 && (hs == nullptr || gs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(xdt, dA, Bm, Cm, dy, dx, ddA, dB, dC, hs, gs, scratch,
                               scratch + static_cast<size_t>(B) * H * S * N, B, S, H, P, N, Q,
                               device, s);
    case 1:
      return launch_bwd_bf16(xdt, dA, Bm, Cm, dy, dx, ddA, dB, dC, hs, gs, scratch, B, S, H, P,
                             N, Q, hs_given, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
