// Decode attention with the keys split across warps and 16-byte loads,
// for Hopper (sm_90a): the body of all four decode-attention kernels.
// decode_attention.cu and paged_decode_attention.cu run it for one query
// token per row over a dense cache (DenseRows) or a block pool
// (PagedRows); tree_decode_attention.cu adds A speculative tail entries
// per row (Tail).  Written over the `Rows` policies of decode_tiles.cuh,
// the kernels compute the same arithmetic and differ only in addresses.
//
// One block serves one (row b, KV head h, candidate a) and up to GT of its
// G query heads (blockIdx.y picks which GT; at G <= 8 one block holds them
// all, so each K/V entry is read once per row and candidate).  Its warps
// take the row's first kv_len[b] keys in interleaved groups.  Within a
// warp, L = D * sizeof(T) / 16 lanes cover one key, each lane one 16-byte
// chunk of it (two at float32 D > 128), so 32 / L' keys (L' = L rounded up
// to a power of two) are in flight per warp step; each lane holds its
// chunk of the GT queries as float32 registers.  Per step a lane issues
// one 16-byte load of K and one of V per key, kUnroll steps ahead of their
// use; the dot partials are summed over the key's lanes with log2 L'
// shuffles, all kUnroll * GT sums of a level at once (a loop per sum
// would chain the shuffles' latencies).  Each lane group keeps its own
// online-softmax state (running max m, sum l, float32 acc of its chunk)
// for the GT queries, in log2 units (exp2f, accurate to 2 ulp), one
// update per kUnroll keys; the groups of a warp merge by shuffles, the
// warps in shared memory (each rescaled by 2^(m_w - m)), and the output
// is acc / max(l, 1e-20): a row with kv_len = 0 reads nothing and gives
// zeros.  Nothing past kv_len is read.

#pragma once

#include "decode_tiles.cuh"

namespace decode_split {

using decode_tiles::kNegInf;

constexpr int kWarps = 4;
// Warp steps whose loads are issued together (halved where a lane holds
// two chunks of each key).
constexpr int kUnroll = 4;

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// 16 bytes of T as float32.
__device__ __forceinline__ void widen(uint4 x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void widen(uint4 x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// float32 -> 16 bytes of T.
__device__ __forceinline__ uint4 narrow(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The speculative tail of a tree-decode step: A candidates per row, q and
// out [B, A, Hq, D], entries k/v [B, A, Hkv, D], candidate a seeing entry
// j where mask[a, j] != 0 (A <= 32).  A plain decode step has A = 1 and no
// entries.
template <typename T>
struct Tail {
  const T* k;
  const T* v;
  const int32_t* mask;
  int A;
};

// Dynamic shared memory of one block: each warp's acc [GT][D], m and l.
inline size_t smem_bytes(int GT, int D) {
  return sizeof(float) * static_cast<size_t>(kWarps) * GT * (D + 2);
}

// q [B, A, Hkv * G, D] and out alike; prefix K/V rows from `rows`.  L =
// D / E chunks per key, lp_log2 = log2 of the lanes per key (the power of
// two >= L / NC).  blockIdx.x = (b * Hkv + h) * A + a: the A candidates of
// a (row, KV head) read its prefix back to back, the second time on from
// L2.  blockIdx.y = query group.  With kTail, candidate a's logical keys
// are the row's len prefix keys, then the tail entries it sees in order
// of j: with the identity mask, exactly the keys of a plain step over the
// prefix with entry a appended, in the same order and arithmetic.
template <typename T, int GT, int NC, class Rows, bool kTail>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ kv_len,
             T* __restrict__ out, Rows rows, Tail<T> tail, int Hkv, int G,
             int D, int L, int lp_log2, float scale) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int U = kUnroll / NC;
  extern __shared__ float smem[];
  float* acc_s = smem;                      // [kWarps][GT][D]
  float* m_s = acc_s + kWarps * GT * D;     // [kWarps][GT]
  float* l_s = m_s + kWarps * GT;           // [kWarps][GT]
  __shared__ int visible[32];               // tail entries, in order

  const int A = tail.A;
  const int bh = blockIdx.x / A;
  const int a = blockIdx.x - bh * A;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, G - g0);
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lp = 1 << lp_log2;       // lanes per key
  const int kps = 32 >> lp_log2;     // keys per warp step
  const int kg = lane >> lp_log2;    // this lane's key in the step
  const int sub = lane & (lp - 1);   // its chunk (and sub + lp)
  const int len = max(0, min(kv_len[b], rows.limit()));
  // Scores in log2 units: p = 2^(s * log2(e) - m), one exp2f each.
  const float scale2 = scale * 1.4426950408889634f;

  int n_keys = len;
  if (kTail) {
    const bool sees = lane < A && tail.mask[a * A + lane] != 0;
    const unsigned seen = __ballot_sync(0xffffffffu, sees);
    if (warp == 0 && sees) visible[__popc(seen & ((1u << lane) - 1u))] = lane;
    n_keys += __popc(seen);
    __syncthreads();
  }

  // q row of query (g0 + j): q[b, a, h * G + g0 + j, :].
  const long long q_row =
      ((static_cast<long long>(b) * A + a) * Hq + h * G + g0) *
      static_cast<long long>(D);
  bool live[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) live[i] = sub + i * lp < L;

  float qf[GT][NC][E];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (j < ng && live[i])
        x = load16(q + q_row + static_cast<long long>(j) * D + (sub + i * lp) * E);
      widen(x, qf[j][i]);
    }
  }

  float m[GT], l[GT], acc[GT][NC][E];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][i][e] = 0.0f;
  }

  const int per_iter = kWarps * kps * U;
  for (int base = 0; base < n_keys; base += per_iter) {
    // Issue every load of the U steps before any is used.
    uint4 kc[U][NC], vc[U][NC];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + (u * kWarps + warp) * kps + kg;
      valid[u] = t < n_keys;
      const T* ks = k;
      const T* vs = v;
      long long off = 0;
      if (valid[u]) {
        if (!kTail || t < len) {
          off = rows.offset(b, h, t, Hkv, D);
        } else {
          ks = tail.k;
          vs = tail.v;
          off = ((static_cast<long long>(b) * A + visible[t - len]) * Hkv + h) *
                static_cast<long long>(D);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        kc[u][i] = vc[u][i] = make_uint4(0u, 0u, 0u, 0u);
        if (valid[u] && live[i]) {
          kc[u][i] = load16(ks + off + (sub + i * lp) * E);
          vc[u][i] = load16(vs + off + (sub + i * lp) * E);
        }
      }
    }

    // Scores of the U keys for every query: the dot partials of this
    // lane's chunk, then summed over the key's lanes, the shuffle level
    // outermost so the U * GT shuffles of a level are independent.
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NC][E];
#pragma unroll
      for (int i = 0; i < NC; ++i) widen(kc[u][i], kf[i]);
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[j][i][e], kf[i][e], dot);
        s[u][j] = dot;
      }
    }
    for (int o = lp >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < GT; ++j)
          s[u][j] += __shfl_xor_sync(0xffffffffu, s[u][j], o);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < GT; ++j)
        s[u][j] = valid[u] ? s[u][j] * scale2 : kNegInf;

    // One online-softmax update for the U keys, then acc += p.V.
    float p[U][GT], a[GT];
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      float m_new = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u][j]);
      a[j] = exp2f(m[j] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][j] = valid[u] ? exp2f(s[u][j] - m_new) : 0.0f;
        sum += p[u][j];
      }
      l[j] = l[j] * a[j] + sum;
      m[j] = m_new;
    }
    // acc = acc * a + sum_u p_u v_u, the rescale folded into the first FMA.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[NC][E];
#pragma unroll
      for (int i = 0; i < NC; ++i) widen(vc[u][i], vf[i]);
#pragma unroll
      for (int j = 0; j < GT; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[j][i][e] = u == 0 ? fmaf(acc[j][i][e], a[j], p[u][j] * vf[i][e])
                                  : fmaf(p[u][j], vf[i][e], acc[j][i][e]);
    }
  }

  // Merge the warp's key groups: partner states by shuffles, each side
  // rescaled to the larger max.  A group that saw no key has m = -1e30,
  // l = 0 and acc = 0, and merges to nothing (exp(0) = 1 only when both
  // sides are empty, and then both sums are 0).
  for (int o = lp; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[j], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[j], o);
      const float m_new = fmaxf(m[j], m2);
      const float a1 = exp2f(m[j] - m_new);
      const float a2 = exp2f(m2 - m_new);
      l[j] = l[j] * a1 + l2 * a2;
      m[j] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x2 = __shfl_xor_sync(0xffffffffu, acc[j][i][e], o);
          acc[j][i][e] = acc[j][i][e] * a1 + x2 * a2;
        }
    }
  }

  // The warps' states to shared memory (key group 0 holds the merge).
  if (kg == 0) {
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      float* dst = acc_s + (warp * GT + j) * D;
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (live[i])
#pragma unroll
          for (int e = 0; e < E; ++e) dst[(sub + i * lp) * E + e] = acc[j][i][e];
      if (sub == 0) {
        m_s[warp * GT + j] = m[j];
        l_s[warp * GT + j] = l[j];
      }
    }
  }
  __syncthreads();

  // One thread per (query, chunk): merge the warps, divide, 16-byte store.
  for (int idx = tid; idx < ng * L; idx += kWarps * 32) {
    const int j = idx / L;
    const int ch = idx - j * L;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, m_s[w * GT + j]);
    float lt = 0.0f;
    float o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(m_s[w * GT + j] - mt);
      lt = fmaf(l_s[w * GT + j], a, lt);
      const float* src = acc_s + (w * GT + j) * D + ch * E;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = fmaf(src[e], a, o[e]);
    }
    const float denom = fmaxf(lt, 1e-20f);
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] /= denom;
    *reinterpret_cast<uint4*>(out + q_row + static_cast<long long>(j) * D +
                              ch * E) = narrow(o);
  }
}

// Launch split_kernel on `stream`: B * Hkv * A x ceil(G / GT) blocks.
// Returns the cudaError_t of the launch (0: queued).
template <typename T, int GT, int NC, class Rows, bool kTail>
int launch_gt(const void* q, const void* k, const void* v,
              const int32_t* kv_len, void* out, Rows rows, Tail<T> tail,
              int B, int Hkv, int G, int D, int L, int lp_log2, float scale,
              cudaStream_t stream) {
  const dim3 grid(B * Hkv * tail.A, (G + GT - 1) / GT);
  split_kernel<T, GT, NC, Rows, kTail>
      <<<grid, kWarps * 32, smem_bytes(GT, D), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), kv_len, static_cast<T*>(out), rows, tail,
          Hkv, G, D, L, lp_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

// The smallest GT of {1, 2, 4, 8} that holds G (8 for G > 8).
template <typename T, int NC, class Rows, bool kTail>
int launch_g(const void* q, const void* k, const void* v,
             const int32_t* kv_len, void* out, Rows rows, Tail<T> tail, int B,
             int Hkv, int G, int D, int L, int lp_log2, float scale,
             cudaStream_t stream) {
  if (G <= 1)
    return launch_gt<T, 1, NC, Rows, kTail>(q, k, v, kv_len, out, rows, tail,
                                            B, Hkv, G, D, L, lp_log2, scale,
                                            stream);
  if (G <= 2)
    return launch_gt<T, 2, NC, Rows, kTail>(q, k, v, kv_len, out, rows, tail,
                                            B, Hkv, G, D, L, lp_log2, scale,
                                            stream);
  if (G <= 4)
    return launch_gt<T, 4, NC, Rows, kTail>(q, k, v, kv_len, out, rows, tail,
                                            B, Hkv, G, D, L, lp_log2, scale,
                                            stream);
  return launch_gt<T, 8, NC, Rows, kTail>(q, k, v, kv_len, out, rows, tail, B,
                                          Hkv, G, D, L, lp_log2, scale,
                                          stream);
}

// D must be a multiple of 16 / sizeof(T) and at most 256, and every
// pointer 16-byte aligned (the wrappers check both); kTail: 1 <= A <= 32.
template <typename T, class Rows, bool kTail = false>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           void* out, Rows rows, int B, int Hkv, int G, int D, float scale,
           cudaStream_t stream, Tail<T> tail = Tail<T>{nullptr, nullptr, nullptr, 1}) {
  constexpr int E = 16 / sizeof(T);
  if (D <= 0 || D % E != 0 || D > 256 || G <= 0 || tail.A < 1 || tail.A > 32 ||
      (!kTail && tail.A != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = D / E;
  constexpr int NC = sizeof(T) == 4 ? 2 : 1;  // float32 D > 128: two chunks
  if (NC == 1 || L <= 32) {
    int lp_log2 = 0;
    while ((1 << lp_log2) < L) ++lp_log2;
    return launch_g<T, 1, Rows, kTail>(q, k, v, kv_len, out, rows, tail, B,
                                       Hkv, G, D, L, lp_log2, scale, stream);
  }
  return launch_g<T, NC, Rows, kTail>(q, k, v, kv_len, out, rows, tail, B, Hkv,
                                      G, D, L, 5, scale, stream);
}

}  // namespace decode_split
