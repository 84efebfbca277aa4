// Shared body of the port's decode-attention kernels, for Hopper (sm_90a).
// Included by decode_attention.cu (dense, A = 1), paged_decode_attention.cu
// (paged, A = 1) and tree_decode_attention.cu (dense and paged, A tail
// entries).
//
// One block serves one (row b, KV head h).  It holds Q = A * G query
// vectors: the G query heads of KV head h for each of the row's A
// candidates (A = 1 for a plain decode step).  Query vector r = a * G + g is
//
//   q[b, a, h * G + g, :]   of q [B, A, Hq, D],   Hq = Hkv * G,
//
// and the output has the same layout.  The block streams the row's first
// kv_len[b] prefix keys ONCE, in tiles of 32 keys converted to float32 in
// shared memory, and folds every tile into all Q online-softmax states
// (running max m, sum l, accumulator acc, all float32).  The key addresses
// come from a `Rows` policy: DenseRows reads a [B, S, Hkv, D] cache,
// PagedRows a [P, bs, Hkv, D] pool through the row's page table.  With a
// tail, the row's A speculative entries k_spec/v_spec [B, A, Hkv, D] are
// folded in last as one more tile, query vector (a, g) seeing entry j only
// where mask[a, j] != 0.  The output is acc / max(l, 1e-20): a query with
// nothing to attend gives zeros.
//
// What bounds it depends on Q.  Each valid prefix K/V entry is read once
// per (row, KV head) and used by all Q query vectors: 4 * Q flops per K/V
// element pair, which is 4 bytes in bf16, so Q flops per byte.  The card's
// float32 rate outside the tensor cores is about 20 flops per byte of
// device memory (67e12 / 3.35e12).  At A = 1 (the decode steps, Q = G = 4)
// the kernel is bounded by device-memory bytes.  At the tree kernels' main
// path Q = A * G = 8 * 4 = 32 it is bounded by the float32 score and p.V
// loops, whose every FMA reads two operands from shared memory; bytes bound
// it only once those loops move to register tiles or tensor cores.  The
// design spends the reads once (the point of the TPU tree kernel) and keeps
// q, acc and the tiles in shared memory; register tiling, vectorised
// loads, split-KV and tensor cores are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_tiles {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element offset of logical key t of row b, KV head h, in a dense cache
// [B, S, Hkv, D].
struct DenseRows {
  int S;
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    return ((static_cast<long long>(b) * S + t) * Hkv + h) *
           static_cast<long long>(D);
  }
};

// Element offset of logical key t of row b, KV head h, in a pool
// [P, bs, Hkv, D] addressed through table [B, n_pages]: key t lives at
// (table[b, t / bs], t % bs).  Only the row's live pages (t < kv_len, so
// t / bs < ceil(kv_len / bs)) are ever looked up, and each id is clamped
// into [0, P - 1], so a sentinel or stale entry past the live pages is
// never dereferenced.
struct PagedRows {
  const int32_t* table;
  int n_pages, P, bs;
  __device__ __forceinline__ int limit() const { return n_pages * bs; }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    const int page = t / bs;
    const int off = t - page * bs;
    int blk = table[static_cast<long long>(b) * n_pages + page];
    blk = min(max(blk, 0), P - 1);
    return ((static_cast<long long>(blk) * bs + off) * Hkv + h) *
           static_cast<long long>(D);
  }
};

// Bytes of dynamic shared memory one block needs for Q query vectors: the
// float buffers, one float of padding that aligns the kTile 64-bit key
// offsets, and the offsets themselves (two floats each).
inline size_t smem_bytes(int Q, int D) {
  const size_t floats = 2 * static_cast<size_t>(Q) * D          // q, acc
                        + static_cast<size_t>(kTile) * (D + 1)  // k (padded)
                        + static_cast<size_t>(kTile) * D        // v
                        + static_cast<size_t>(Q) * kTile        // scores / p
                        + 3 * static_cast<size_t>(Q) + 1        // m, l, alpha
                        + 2 * static_cast<size_t>(kTile);       // key offsets
  return floats * sizeof(float);
}

// One block per (row, KV head): blockIdx.x = b * Hkv + h.  k_spec, v_spec
// and mask are read only when kTail.
template <typename T, class Rows, bool kTail>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ kv_len,
              const T* __restrict__ k_spec, const T* __restrict__ v_spec,
              const int32_t* __restrict__ mask, T* __restrict__ out, Rows rows,
              int A, int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  const int Q = A * G;
  float* qs = smem;
  float* acc = qs + Q * D;
  float* ks = acc + Q * D;
  float* vs = ks + kTile * (D + 1);
  float* ps = vs + kTile * D;
  float* m = ps + Q * kTile;
  float* l = m + Q;
  float* alpha = l + Q;
  long long* koff = reinterpret_cast<long long*>(alpha + Q + (Q & 1));

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = max(0, min(kv_len[b], rows.limit()));

  // Query vector r = a * G + g sits at q[b, a, h * G + g, :].
  auto qrow = [&](int r) -> long long {
    const int a = r / G;
    const int g = r - a * G;
    return ((static_cast<long long>(b) * A + a) * Hq + h * G + g) *
           static_cast<long long>(D);
  };
  for (int e = tid; e < Q * D; e += blockDim.x) {
    const int r = e / D;
    qs[e] = to_f32(q[qrow(r) + (e - r * D)]);
    acc[e] = 0.0f;
  }
  for (int r = tid; r < Q; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  // Prefix tiles, then (with a tail) one tile of the A speculative entries.
  const int n_tiles = (len + kTile - 1) / kTile + (kTail ? 1 : 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool is_tail = kTail && tile == n_tiles - 1;
    const int k0 = tile * kTile;
    const int n = is_tail ? A : min(kTile, len - k0);
    if (tid < kTile) {
      long long off = -1;
      if (tid < n) {
        off = is_tail ? ((static_cast<long long>(b) * A + tid) * Hkv + h) *
                            static_cast<long long>(D)
                      : rows.offset(b, h, k0 + tid, Hkv, D);
      }
      koff[tid] = off;
    }
    __syncthreads();  // koff ready; the previous tile's readers are done

    const T* ksrc = is_tail ? k_spec : k;
    const T* vsrc = is_tail ? v_spec : v;
    for (int e = tid; e < kTile * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      float kx = 0.0f, vx = 0.0f;
      if (j < n) {
        const long long off = koff[j] + d;
        kx = to_f32(ksrc[off]);
        vx = to_f32(vsrc[off]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    // Scores: one thread per (query vector, key).
    for (int e = tid; e < Q * kTile; e += blockDim.x) {
      const int r = e / kTile;
      const int j = e - r * kTile;
      bool valid = j < n;
      if (is_tail && valid) valid = mask[(r / G) * A + j] != 0;
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + r * D;
        const float* kj = ks + j * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query vector, one lane per key.
    for (int r = warp; r < Q; r += nwarps) {
      const float s = ps[r * kTile + lane];
      bool valid = lane < n;
      if (is_tail && valid) valid = mask[(r / G) * A + lane] != 0;
      float mx = valid ? s : kNegInf;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * kTile + lane] = p;
      __syncwarp();  // every lane has read m[r] before lane 0 moves it
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // p.V: one thread per output element.
    for (int e = tid; e < Q * D; e += blockDim.x) {
      const int r = e / D;
      const int d = e - r * D;
      const float* pr = ps + r * kTile;
      float o = 0.0f;
      for (int j = 0; j < n; ++j) o = fmaf(pr[j], vs[j * D + d], o);
      acc[e] = acc[e] * alpha[r] + o;
    }
    // The next tile's first barrier orders these reads before its writes.
  }
  __syncthreads();

  for (int e = tid; e < Q * D; e += blockDim.x) {
    const int r = e / D;
    store(out + qrow(r) + (e - r * D), acc[e] / fmaxf(l[r], 1e-20f));
  }
}

// Launch attend_kernel<T, Rows, kTail> on `stream`: B * Hkv blocks.
// Returns the cudaError_t of the launch (0: queued).
template <typename T, class Rows, bool kTail>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           const void* k_spec, const void* v_spec, const int32_t* mask,
           void* out, Rows rows, int B, int A, int Hkv, int G, int D,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(A * G, D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attend_kernel<T, Rows, kTail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attend_kernel<T, Rows, kTail><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(k_spec),
      static_cast<const T*>(v_spec), mask, static_cast<T*>(out), rows, A, Hkv,
      G, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_tiles
