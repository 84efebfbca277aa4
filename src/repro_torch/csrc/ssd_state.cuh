// The state body of the Mamba-2 SSD scan's bf16 (B/C) tensor-core kernels
// for Hopper (sm_90a), shared by the forward (ssd_scan.cu:
// `ssd_fwd_state_mma_kernel`) and the backward (ssd_scan_bwd.cu:
// `ssd_bwd_state_mma_kernel`), each of which wraps `state_pass` in its own
// __global__ so that a profile tells them apart.  Also the tile helpers
// both libraries use around it, on mma_tiles.cuh's primitives.
//
// Per (batch, head) and chunk of Q tokens, with cum the running sum of dA
// from the chunk's start and total = cum[Q - 1]:
//
//   forward   h <- exp(total) h + sum_t (exp(total - cum_t) xdt_t)^T B_t
//   backward  g <- exp(total) g + sum_t (exp(cum_t) dy_t)^T C_t
//
// an MMA with K = Q over 32-token slabs: u = xdt or dy (float32) weighted
// and split hi + lo (two products), v = B or C (bf16, exact).  The states
// go to float32 [B, nc, H, P, N]: forward the state entering each chunk c
// = 1 .. nc - 1 (h_0 = 0 is never written), backward the gradient leaving
// each chunk c = nc - 2 .. 0; forward, given `hout` [B, H, P, N], also the
// state after the last chunk.  The forward's chunk kernel reads the states
// back for the carried-state term exp(cum_i) C_i . h^T of y.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace ssd_state {

namespace tc = mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int kStThreads = 256;   // 8 warps
constexpr int kStSlab = 32;       // tokens per staged slab
constexpr int kUld = 64 + 4;      // floats per raw u row
constexpr int kStStages = 3;      // depth of the cp.async ring

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ __forceinline__ int round32(int x) { return (x + 31) & ~31; }

// Inclusive scan of a[0, len) in place by one warp, 32 entries at a time;
// entries [len, round32(len)) get the running total.
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

// Position q of a lane's 8 values of a 16 x 16 tile is row g + 8 ((q & 3)
// >> 1), column 2c + (q & 1) + 8 (q >> 2), lane = 4 g + c: paired in
// order, the A fragment of that tile, split hi + lo.
__device__ __forceinline__ void split_frag(const float (&v)[8], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) tc::split_bf16(v[2 * k], v[2 * k + 1], hi[k], lo[k]);
}

// Elements n, n + 1 of a bf16 row of length N as a packed pair; zero past N
// or when !ok.
__device__ __forceinline__ uint32_t ld_bf16x2(const bf16* row, int n, int N, bool ok) {
  if (!ok || n >= N) return 0u;
  if ((N & 1) == 0) return *reinterpret_cast<const uint32_t*>(row + n);
  const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
  return static_cast<uint32_t>(r16[n]) |
         (n + 1 < N ? static_cast<uint32_t>(r16[n + 1]) << 16 : 0u);
}
// Elements p, p + 1 of a float32 row of length P; zero past P or when !ok.
__device__ __forceinline__ float2 ld_f2(const float* row, int p, int P, bool ok) {
  if (!ok || p >= P) return make_float2(0.0f, 0.0f);
  if ((P & 1) == 0) return *reinterpret_cast<const float2*>(row + p);
  return make_float2(row[p], p + 1 < P ? row[p + 1] : 0.0f);
}
// Stores elements p, p + 1 (those below P) of a float32 row.
__device__ __forceinline__ void st_f2(float* row, int p, int P, float v0, float v1) {
  if (p >= P) return;
  if ((P & 1) == 0) {
    *reinterpret_cast<float2*>(row + p) = make_float2(v0, v1);
  } else {
    row[p] = v0;
    if (p + 1 < P) row[p + 1] = v1;
  }
}

// Rows [r_begin, r_begin + rows) of a chunk's [Q, N] bf16 matrix into
// dst[rows][ld], columns [0, np16); zero at rows >= valid and columns >=
// N.  16-byte cp.async where `vec` (N % 8 == 0, 16-byte aligned rows);
// the caller commits and waits.
__device__ __forceinline__ void stage_bf16_rows(bf16* dst, int ld, const bf16* src, int r_begin,
                                                int rows, int valid, int N, int np16, bool vec,
                                                int tid, int nthreads) {
  const int chunks = np16 / 8;
  for (int e = tid; e < rows * chunks; e += nthreads) {
    const int r = e / chunks;
    const int n = (e - r * chunks) * 8;
    const int row = r_begin + r;
    bf16* d = dst + r * ld + n;
    if (vec) {
      const bool in = row < valid && n < N;
      tc::cp_async16(tc::smem_addr(d), in ? src + static_cast<size_t>(row) * N + n : src, in);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = (row < valid && n + k < N) ? src[static_cast<size_t>(row) * N + n + k]
                                          : __float2bfloat16(0.0f);
    }
  }
}

// ldmatrix addresses of the fragments of a 16 x 16 bf16 tile at `base`
// (row stride `ld` elements): the A fragment from [m][k] storage, and the
// B fragments of two n8 tiles from [n][k] storage (`nk`) or, transposed,
// from [k][n] storage (`kn`).
__device__ __forceinline__ uint32_t a_addr(const bf16* base, int ld, int lane) {
  return tc::smem_addr(base + (lane & 15) * ld + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t b_nk_addr(const bf16* base, int ld, int lane) {
  return tc::smem_addr(base + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t b_kn_addr(const bf16* base, int ld, int lane) {
  return tc::smem_addr(base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

// c += (hi + lo) b with b exact: two products.
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  tc::mma_bf16(c, hi, b0, b1);
  tc::mma_bf16(c, lo, b0, b1);
}

// Dynamic shared memory of `state_pass`.
inline size_t state_smem_bytes(int N, int Q) {
  return sizeof(float) * (2 * round32(Q) + kStStages * kStSlab * kUld) +
         sizeof(bf16) * kStStages * kStSlab * (round16(N) + 8);
}

// Block (batch b, head h, state rows [p0, p0 + 64)) of kStThreads threads:
// walks the chunks in order (forward) or in reverse (`rev`).  Each step:
// state <- exp(total) state + (wt o u)^T v over the chunk's tokens, with
// (u, v, wt) = (xdt, B, exp(total - cum)) forward and (dy, C, exp(cum))
// backward: u wt split (two terms), v exact.  32-token slabs of raw u and
// of v come in through a kStStages-deep cp.async ring; the A fragments of
// (wt o u)^T are read from the raw slab, scaled and split.  Warp w owns
// state rows p0 + 16 (w & 3) + [0, 16) and half the 16-column pairs of N
// (NPW of them at most).  The states go to hs (forward) or gs (backward),
// the forward's last to hout when given.
template <int NPW>
__device__ __forceinline__ void state_pass(
    unsigned char* smem_raw, const float* __restrict__ xdt, const float* __restrict__ dA,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ dy,
    float* __restrict__ hs, float* __restrict__ gs, float* __restrict__ hout, bool rev, int S,
    int H, int P, int N, int Q, int vec_bc, int vec_u) {
  const int np16 = round16(N);
  const int ldv = np16 + 8;
  const int qp = round32(Q);
  float* cum = reinterpret_cast<float*>(smem_raw);   // [qp]
  float* wt = cum + qp;                               // [qp]
  float* ring = wt + qp;                              // [kStStages][kStSlab][kUld]  raw u
  // [kStStages][kStSlab][ldv]  v
  bf16* vring = reinterpret_cast<bf16*>(ring + kStStages * kStSlab * kUld);

  const int p_groups = (P + 63) / 64;
  int idx = blockIdx.x;
  const int p0 = 64 * (idx % p_groups);
  idx /= p_groups;
  const int h = idx % H;
  const int b = idx / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int nc = S / Q;
  const int pairs = np16 / 16;
  const int ppw = (pairs + 1) / 2;
  const int pbeg = (warp >> 2) * ppw;
  const int pend = min(pairs, pbeg + ppw);
  const int pm = p0 + 16 * (warp & 3);                // the warp's first state row
  const bool live = pm < P;
  const size_t x_tok = static_cast<size_t>(H) * P;
  const float* ub =
      (rev ? dy : xdt) + static_cast<size_t>(b) * S * x_tok + static_cast<size_t>(h) * P;
  const bf16* vb = (rev ? Cm : Bm) + static_cast<size_t>(b) * S * N;
  const float* ab = dA + static_cast<size_t>(b) * S * H + h;
  float* out = rev ? gs : hs;
  const int n_slabs = (Q + kStSlab - 1) / kStSlab;
  const int steps = rev || hout == nullptr ? nc - 1 : nc;

  float state[NPW][2][4];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int k = 0; k < 4; ++k) state[i][hf][k] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int ch = rev ? nc - 1 - step : step;
    const size_t t0 = static_cast<size_t>(ch) * Q;
    auto fetch = [&](int s) {
      float* ru = ring + (s % kStStages) * kStSlab * kUld;
      const int ks = kStSlab * s;
      for (int e = tid; e < kStSlab * 16; e += kStThreads) {
        const int r = e >> 4;
        const int p = 4 * (e & 15);
        const int t = ks + r;
        const float* src = ub + (t0 + t) * x_tok + p0 + p;
        const uint32_t dst = tc::smem_addr(ru + r * kUld + p);
        if (vec_u) {
          const bool in = t < Q && p0 + p < P;
          tc::cp_async16(dst, in ? src : ub, in);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = t < Q && p0 + p + u < P;
            tc::cp_async4(dst + 4 * u, in ? src + u : ub, in);
          }
        }
      }
      stage_bf16_rows(vring + (s % kStStages) * kStSlab * ldv, ldv, vb + t0 * N, ks, kStSlab, Q,
                      N, np16, vec_bc, tid, kStThreads);
    };
    __syncthreads();  // the last step's readers of cum, wt, the ring and h are done
#pragma unroll
    for (int s = 0; s < kStStages - 1; ++s) {
      if (s < n_slabs) fetch(s);
      tc::cp_async_commit();
    }
    for (int i = tid; i < Q; i += kStThreads) cum[i] = ab[(t0 + i) * H];
    __syncthreads();
    if (warp == 0) warp_scan(cum, Q, lane);
    __syncthreads();
    const float total = cum[Q - 1];
    for (int i = tid; i < qp; i += kStThreads)
      wt[i] = i < Q ? (rev ? expf(cum[i]) : expf(total - cum[i])) : 0.0f;


    float acc[NPW][2][4];
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][hf][k] = 0.0f;
    for (int s = 0; s < n_slabs; ++s) {
      tc::cp_async_wait<kStStages - 2>();
      __syncthreads();  // slab s is in (and wt); the last slab's readers are done
      if (s + kStStages - 1 < n_slabs) fetch(s + kStStages - 1);
      tc::cp_async_commit();
      if (!live) continue;
      const float* ru = ring + (s % kStStages) * kStSlab * kUld;
      const bf16* vs = vring + (s % kStStages) * kStSlab * ldv;
#pragma unroll
      for (int kk = 0; kk < kStSlab / 16; ++kk) {
        // A = (wt o u)^T: element (state row m, token k) is u[k][m] wt[k].
        const int k0 = 16 * kk + 2 * c4;
        const int m0 = 16 * (warp & 3) + g;
        const float* w = wt + kStSlab * s + k0;
        float v[8];
        v[0] = ru[k0 * kUld + m0] * w[0];
        v[1] = ru[(k0 + 1) * kUld + m0] * w[1];
        v[2] = ru[k0 * kUld + m0 + 8] * w[0];
        v[3] = ru[(k0 + 1) * kUld + m0 + 8] * w[1];
        v[4] = ru[(k0 + 8) * kUld + m0] * w[8];
        v[5] = ru[(k0 + 9) * kUld + m0] * w[9];
        v[6] = ru[(k0 + 8) * kUld + m0 + 8] * w[8];
        v[7] = ru[(k0 + 9) * kUld + m0 + 8] * w[9];
        uint32_t ah[4], al[4];
        split_frag(v, ah, al);
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          const int np = pbeg + i;
          if (np < pend) {
            uint32_t bk[4];
            tc::ldsm_x4_trans(bk, b_kn_addr(vs + 16 * kk * ldv + 16 * np, ldv, lane));
            mma2(acc[i][0], ah, al, bk[0], bk[1]);
            mma2(acc[i][1], ah, al, bk[2], bk[3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    if (!live) continue;
    const float keep = expf(total);
    const int c_out = rev ? ch - 1 : ch + 1;
    float* dst = c_out == nc ? hout + (static_cast<size_t>(b) * H + h) * P * N
                             : out + ((static_cast<size_t>(b) * nc + c_out) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int np = pbeg + i;
      if (np >= pend) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * np + 8 * hf + 2 * c4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int p = pm + g + 8 * rr;
          float& s0 = state[i][hf][2 * rr];
          float& s1 = state[i][hf][2 * rr + 1];
          s0 = s0 * keep + acc[i][hf][2 * rr];
          s1 = s1 * keep + acc[i][hf][2 * rr + 1];
          if (p < P) st_f2(dst + static_cast<size_t>(p) * N, n, N, s0, s1);
        }
      }
    }
  }
}

// f(std::integral_constant<int, NPW>) for the NPW that `state_pass` needs
// at state width N: half the 16-column pairs of N a warp.
template <typename F>
cudaError_t with_npw(int N, F&& f) {
  const int ppw = (round16(N) / 16 + 1) / 2;
  if (ppw <= 1) return f(std::integral_constant<int, 1>{});
  if (ppw <= 2) return f(std::integral_constant<int, 2>{});
  if (ppw <= 4) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

}  // namespace ssd_state
