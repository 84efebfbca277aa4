// Decode attention with the keys split across warps and 16-byte loads,
// for Hopper (sm_90a): the body of all four decode-attention kernels.
// decode_attention.cu and paged_decode_attention.cu run it for one query
// token per row over a dense cache (DenseRows) or a block pool
// (PagedRows); tree_decode_attention.cu runs it once per candidate, with A
// speculative tail entries per row (Tail), over a copy of the row's prefix
// in shared memory (Staged).  Written over the `Rows` policies of
// decode_tiles.cuh, the kernels compute the same arithmetic and differ
// only in where a key's bytes come from.
//
// split_body serves one (row b, KV head h, candidate a) and up to GT of
// its G query heads with one group of kWarps warps.  The decode kernels
// run one group per block: one block per (row, KV head), query group
// (blockIdx.y picks which GT; at G <= 8 one block holds them all, so each
// K/V entry is read once per row) and part of S (blockIdx.z; one part
// unless the grid is too small for the card, then the parts' float32
// outputs and log-sum-exps merge in merge_kernel); the tree kernel runs
// several groups per block over a row's candidates (see
// tree_decode_attention.cu).  The group's warps take the candidate's keys
// in interleaved groups.  Within a warp, L = D * sizeof(T) / 16 lanes
// cover one key, each lane one 16-byte chunk of it (two at float32 D >
// 128), so 32 / L' keys (L' = L rounded up to a power of two) are in
// flight per warp step; each lane holds its chunk of the GT queries as
// float32 registers.  A key-loop iteration takes kUnroll steps; a lane
// reads one 16-byte chunk of K and one of V per key, in the decode
// kernels through a cp.async ring of kRing iterations in shared memory
// (the next iteration's copies in flight while this one's chunks are
// used), in the tree kernels from its staged copy; the dot partials are
// summed over the key's lanes
// with log2 L' shuffles, all kUnroll * GT sums of a level at once (a loop
// per sum would chain the shuffles' latencies).  Each lane group keeps
// its own online-softmax state (running max m, sum l, float32 acc of its
// chunk) for the GT queries, in log2 units (exp2f, accurate to 2 ulp),
// one update per kUnroll keys; the groups of a warp merge by shuffles,
// the warps in shared memory (each rescaled by 2^(m_w - m)), and the
// output is acc / max(l, 1e-20): a row with kv_len = 0 reads nothing and
// gives zeros.  Nothing past kv_len is read.

#pragma once

#include <type_traits>

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
// j where mask[a, j] != 0 (A <= 32; a null mask: the identity).  A plain
// decode step has A = 1 and no entries.
template <typename T>
struct Tail {
  const T* k;
  const T* v;
  const int32_t* mask;
  int A;
};

// Keys a tree kernel has copied into shared memory, K rows at shared
// address k and V rows at v ([rows][D] each): the row's first n prefix
// keys (rows 0 .. n - 1), the A tail entries (rows tail .. tail + A - 1)
// and a row of zeros (row zero).  The prefix lands in `chunks` chunks of
// `chunk` keys, the tail with the first; chunk c has landed once phase 0
// of the mbarrier at bars + 8 c has completed.  The decode kernels stage
// nothing.
struct Staged {
  uint32_t k, v, bars;
  int n, chunk, chunks, tail, zero;
};

__device__ __forceinline__ uint4 load16_shared(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr));
  return x;
}

// The decode kernels' keys from device memory pass through a ring of
// kRing key-loop iterations in shared memory, filled by cp.async: the next
// iteration's K/V chunks are in flight while this one's are used, without
// registers to hold them.  A lane reads back only the chunks it copied.
constexpr int kRing = 2;
// Bytes of the ring: kRing iterations x kUnroll chunk steps x (K, V) x the
// block's lanes x 16 bytes (U * NC = kUnroll chunks a lane an iteration).
constexpr int kRingBytes = kRing * kUnroll * 2 * kWarps * 32 * 16;

// 16 bytes at src to shared address dst, asynchronously; zeros where !ok
// (src is then not read).
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 2^x for x >= -126 (a normal result): the MUFU.EX2 that exp2f runs on
// such x, without exp2f's scaling of smaller x.
__device__ __forceinline__ float ex2_normal(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Wait until phase 0 of the mbarrier at shared address `bar` completes.
__device__ __forceinline__ void wait_landed(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
}

// Where a step's K and V chunks come from: fetch(u, i, is_v) is chunk i
// (of NC) of the key of warp step u, K or V.  Ring: this lane's chunks of
// one ring stage (the decode kernels), at shared address slot + ((u * NC +
// i) * 2 + is_v) * unit, unit = the block's lanes x 16 bytes.
template <int U, int NC>
struct Ring {
  uint32_t slot;
  __device__ __forceinline__ uint4 operator()(int u, int i, bool is_v) const {
    constexpr uint32_t kUnit = kWarps * 32 * 16;
    return load16_shared(slot + ((u * NC + i) * 2 + (is_v ? 1u : 0u)) * kUnit);
  }
};

// Staged rows ([row][D] for K and for V), read from shared memory at use:
// row_at[u] is the address of step u's key's K row, its V row v_off
// further, chunk[i] the lane's chunk i in the row.  A lane past the key's
// L chunks reads chunk 0 instead: its q is zero, so its partial score is
// +0, as from a zero chunk, and its acc is never stored.
template <int U, int NC>
struct RowsShared {
  uint32_t row_at[U];
  uint32_t v_off;
  uint32_t chunk[NC];
  __device__ __forceinline__ uint4 operator()(int u, int i, bool is_v) const {
    return load16_shared(row_at[u] + chunk[i] + (is_v ? v_off : 0u));
  }
};

// Any key, read at use: staged (element offset off in the copy at shared
// addresses sk, sv), else from ks/vs + off (the prefix or the tail).
template <typename T, int U, int NC>
struct AtUse {
  const T* ks[U];
  const T* vs[U];
  long long off[U];
  bool valid[U], staged[U], live[NC];
  uint32_t sk, sv;
  int sub, lp;
  __device__ __forceinline__ uint4 operator()(int u, int i, bool is_v) const {
    constexpr int E = 16 / sizeof(T);
    if (!valid[u] || !live[i]) return make_uint4(0u, 0u, 0u, 0u);
    const long long c = off[u] + (sub + i * lp) * E;
    if (staged[u])
      return load16_shared((is_v ? sv : sk) + static_cast<uint32_t>(c * sizeof(T)));
    return load16((is_v ? vs[u] : ks[u]) + c);
  }
};

// One step of U warp steps: the scores of the U keys whose K and V chunks
// fetch returns, one online-softmax update of (m, l, acc), acc += p.V.
template <typename T, int GT, int NC, class Fetch>
__device__ __forceinline__ void key_step(
    const Fetch& fetch, const bool (&valid)[kUnroll / NC],
    const float (&qf)[GT][NC][16 / sizeof(T)], float (&m)[GT], float (&l)[GT],
    float (&acc)[GT][NC][16 / sizeof(T)], int lp, float scale2) {
  constexpr int E = 16 / sizeof(T);
  constexpr int U = kUnroll / NC;
  // Scores of the U keys for every query: the dot partials of this
  // lane's chunk, then summed over the key's lanes, the shuffle level
  // outermost so the U * GT shuffles of a level are independent.
  float s[U][GT];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[NC][E];
#pragma unroll
    for (int i = 0; i < NC; ++i) widen(fetch(u, i, false), kf[i]);
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < lp) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < GT; ++j)
          s[u][j] += __shfl_xor_sync(0xffffffffu, s[u][j], o);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < GT; ++j)
      s[u][j] = valid[u] ? s[u][j] * scale2 : kNegInf;

  // One online-softmax update for the U keys, then acc += p.V.
  float p[U][GT], a[GT], m_new[GT];
  bool quick = true;
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    m_new[j] = m[j];
    float lo = s[0][j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m_new[j] = fmaxf(m_new[j], s[u][j]);
      lo = fminf(lo, s[u][j]);
    }
    quick = quick && lo - m_new[j] >= -126.0f;
    a[j] = exp2f(m[j] - m_new[j]);
  }
  // exp2f(x) is MUFU.EX2 of x where x >= -126 (it scales smaller x
  // first): one vote lets the warp take that instruction alone.
  if (__all_sync(0xffffffffu, quick)) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < GT; ++j)
        p[u][j] = valid[u] ? ex2_normal(s[u][j] - m_new[j]) : 0.0f;
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < GT; ++j)
        p[u][j] = valid[u] ? exp2f(s[u][j] - m_new[j]) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) sum += p[u][j];
    l[j] = l[j] * a[j] + sum;
    m[j] = m_new[j];
  }
  // acc = acc * a + sum_u p_u v_u, the rescale folded into the first FMA.
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[NC][E];
#pragma unroll
    for (int i = 0; i < NC; ++i) widen(fetch(u, i, true), vf[i]);
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

// Which query heads a decode call's q holds, and whether it wants their
// log-sum-exp: q and out [B, hq, D] hold heads head0 .. head0 + hq - 1 of
// the model's Hkv * G (a rank's heads under tensor parallelism; hq < 0:
// all of them, head0 = 0); lse, where not null, receives each head's
// log-sum-exp of its scaled scores [B, hq] in float32 (-inf for a row with
// no valid key), for a merge of the parts of a cache split over S.
struct Window {
  int hq, head0;
  float* lse;
};

// A chunk of E outputs to 16 bytes of TO (TO = T: the kernel's own
// rounding), or, for a float32 out of a bf16 body, to 32 bytes of float32.
template <typename TO, int E>
__device__ __forceinline__ void store_chunk(TO* dst, const float (&o)[E]) {
  if constexpr (sizeof(TO) * E == 16) {
    *reinterpret_cast<uint4*>(dst) = narrow(o);
  } else {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(o[0], o[1], o[2], o[3]);
    d4[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// The whole block (the decode kernels: one group per block).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Work a decode kernel's block does after its q loads are issued and
// before its key loop (the paged kernel stages its keys' pool rows): none.
struct NoPrologue {
  __device__ __forceinline__ void operator()() const {}
};

// Dynamic shared memory of one group's merge: each warp's acc [GT][D], m
// and l.
inline size_t smem_bytes(int GT, int D) {
  return sizeof(float) * static_cast<size_t>(kWarps) * GT * (D + 2);
}

// A decode kernel's body: the ring, then the merge in the same space.
__host__ __device__ __forceinline__ int decode_smem_bytes(int GT, int D) {
  const int merge = static_cast<int>(sizeof(float)) * kWarps * GT * (D + 2);
  return merge > kRingBytes ? merge : kRingBytes;
}

// One (row b, KV head h, candidate a) and queries g0 .. g0 + ng - 1 of the
// head's G, on one group of kWarps warps: tid is the thread's index in the
// group, smem the group's merge buffer (smem_bytes), sync a barrier of the
// group's threads.  q [B, A, Hkv * G, D] and out alike (A = tail.A, 1 for
// a decode step), or, for a decode step, the heads of `win` in q and out
// [B, win.hq, D], out in TO; an inactive group (active false) reads no q
// and writes no output.  Logical keys: the row's len prefix keys, keys t < st.n from
// shared memory (kStaged), the others through `rows`; then, with kTail,
// the n_visible tail entries `visible` lists, in order of j.  With the
// identity mask, candidate a's keys are exactly those of a plain step over
// the prefix with entry a appended, in the same order and arithmetic:
// where a key's bytes come from never changes a rounding.  The key loop
// runs to n_bound >= the candidate's key count, the same in every warp
// (ptxas keeps the shuffles free of divergence handling only where every
// loop bound around them is provably uniform); a step with no valid key
// changes nothing (its p are 0 and its loaded V chunks 0, so a = 1 and
// every FMA adds a zero).  L = D / E chunks per key, lp_log2 = log2 of the
// lanes per key (the power of two >= L / NC).
template <typename T, int GT, int NC, class Rows, bool kTail, bool kStaged,
          class Sync, typename TO = T, class Prologue = NoPrologue>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    TO* __restrict__ out, const Rows& rows, const Tail<T>& tail,
    const Staged& st, int& landed, const unsigned char* visible,
    int n_visible, int n_bound, bool active, int b, int h, int a, int len,
    int Hkv, int G, int g0, int ng, int D, int L, int lp_log2, float scale,
    int tid, float* smem, Sync sync, Window win = Window{-1, 0, nullptr},
    const Prologue& prologue = Prologue{}) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int U = kUnroll / NC;
  float* acc_s = smem;                      // [kWarps][GT][D]
  float* m_s = acc_s + kWarps * GT * D;     // [kWarps][GT]
  float* l_s = m_s + kWarps * GT;           // [kWarps][GT]

  const int A = tail.A;
  const int Hq = Hkv * G;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lp = 1 << lp_log2;       // lanes per key
  const int kps = 32 >> lp_log2;     // keys per warp step
  const int kg = lane >> lp_log2;    // this lane's key in the step
  const int sub = lane & (lp - 1);   // its chunk (and sub + lp)
  // Scores in log2 units: p = 2^(s * log2(e) - m), one exp2f each.
  const float scale2 = scale * 1.4426950408889634f;
  const int n_keys = len + (kTail ? n_visible : 0);

  // q row of query (g0 + j): q[b, a, h * G + g0 + j - head0, :], among the
  // q_heads heads q holds.
  const int q_heads = win.hq < 0 ? Hq : win.hq;
  const long long q_head =
      (static_cast<long long>(b) * A + a) * q_heads + h * G + g0 - win.head0;
  const long long q_row = q_head * static_cast<long long>(D);
  bool live[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) live[i] = sub + i * lp < L;

  float qf[GT][NC][E];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (active && j < ng && live[i])
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
  prologue();

  const int per_iter = kWarps * kps * U;
  int base = 0;
  if (kStaged) {
    // Steps read from shared memory at use: all of them when the whole
    // prefix is staged, else those whose keys are all staged.  A key's row
    // is its prefix row, then the row of the tail entry it is (rows after
    // the prefix), then, past the candidate's keys, the zero row, which
    // reads as the zero chunks of an invalid key.
    const int n_shared = st.n == len ? n_bound : st.n - st.n % per_iter;
    RowsShared<U, NC> rows_at;
    rows_at.v_off = st.v - st.k;
#pragma unroll
    for (int i = 0; i < NC; ++i) rows_at.chunk[i] = live[i] ? (sub + i * lp) * 16 : 0;
    const uint32_t row_bytes = D * sizeof(T);
    for (; base < n_shared; base += per_iter) {
      // The staged chunks this step reads must have landed (the tail
      // lands with chunk 0).
      const int need = min(base + per_iter, st.n);
      while (landed == 0 || landed * st.chunk < need)
        wait_landed(st.bars + 8u * landed++);
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + (u * kWarps + warp) * kps + kg;
        valid[u] = t < n_keys;
        const int row = t < len ? t : valid[u] ? st.tail + visible[t - len] : st.zero;
        rows_at.row_at[u] = st.k + row * row_bytes;
      }
      key_step<T, GT, NC>(rows_at, valid, qf, m, l, acc, lp, scale2);
    }
  }
  if constexpr (!kStaged) {
    // The decode kernels: the keys from device memory through the ring in
    // smem (the merge buffer's space), the next iteration's copies issued
    // before this one's chunks are used.  Chunks of a key past n_keys, and
    // of a lane past the key's L chunks, are zeros, as AtUse gives them.
    constexpr uint32_t kUnit = kWarps * 32 * 16;
    constexpr uint32_t kStage = U * NC * 2 * kUnit;
    const uint32_t slot =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + (warp * 32 + lane) * 16u;
    const auto issue = [&](int from, uint32_t stage) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = from + (u * kWarps + warp) * kps + kg;
        const bool valid = t < n_keys;
        const long long off = valid ? rows.offset(b, h, t, Hkv, D) : 0;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const bool ok = valid && live[i];
          const long long c = ok ? off + (sub + i * lp) * E : 0;
          const uint32_t dst = stage + (u * NC + i) * 2 * kUnit;
          copy16(dst, k + c, ok);
          copy16(dst + kUnit, v + c, ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    uint32_t stage = slot;
    if (base < n_bound) issue(base, stage);
    for (; base < n_bound; base += per_iter) {
      const uint32_t next = stage == slot ? slot + kStage : slot;
      if (base + per_iter < n_bound) {
        issue(base + per_iter, next);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) valid[u] = base + (u * kWarps + warp) * kps + kg < n_keys;
      key_step<T, GT, NC>(Ring<U, NC>{stage}, valid, qf, m, l, acc, lp, scale2);
      stage = next;
    }
    // The merge buffer below is the ring's space.
    sync();
  } else {
    // The other steps: keys from shared memory, device memory or the tail,
    // each chunk fetched at its use (rare: the prefix's end, the tail, keys
    // past the copy).
    for (; base < n_bound; base += per_iter) {
      const int need = min(base + per_iter, st.n);
      while (landed * st.chunk < need) wait_landed(st.bars + 8u * landed++);
      AtUse<T, U, NC> at;
      at.sk = st.k;
      at.sv = st.v;
      at.sub = sub;
      at.lp = lp;
#pragma unroll
      for (int i = 0; i < NC; ++i) at.live[i] = live[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + (u * kWarps + warp) * kps + kg;
        at.valid[u] = t < n_keys;
        at.staged[u] = t < st.n;
        at.ks[u] = k;
        at.vs[u] = v;
        at.off[u] = 0;
        if (at.staged[u]) {
          at.off[u] = static_cast<long long>(t) * D;
        } else if (at.valid[u]) {
          if (!kTail || t < len) {
            at.off[u] = rows.offset(b, h, t, Hkv, D);
          } else {
            at.ks[u] = tail.k;
            at.vs[u] = tail.v;
            at.off[u] = ((static_cast<long long>(b) * A + visible[t - len]) * Hkv + h) *
                        static_cast<long long>(D);
          }
        }
      }
      key_step<T, GT, NC>(at, at.valid, qf, m, l, acc, lp, scale2);
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
  sync();

  // One thread per (query, chunk): merge the warps, divide, 16-byte store.
  for (int idx = active ? tid : ng * L; idx < ng * L; idx += kWarps * 32) {
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
    store_chunk(out + q_row + static_cast<long long>(j) * D + ch * E, o);
    // lse = ln(sum_t e^s_t) = (mt + log2 lt) ln 2 in the scores' log2 units.
    if (win.lse != nullptr && ch == 0)
      win.lse[q_head + j] = lt > 0.0f ? (mt + log2f(lt)) * 0.6931471805599453f
                                      : __int_as_float(0xff800000);  // -inf
  }
}

// S split across blocks (the decode kernels): part i of a row holds its
// keys i * keys .. (i + 1) * keys - 1, keys = part_keys(limit, parts), a
// whole number of kPartKeys, which every shape's keys per body iteration
// (kWarps * (32 / lanes per key) * steps: 8 to 512) divide; so a part
// starts where an iteration of the unsplit kernel would.  One part is
// the unsplit kernel: its keys are all the row's.
constexpr int kPartKeys = 512;

inline int part_keys(int limit, int parts) {
  const int per = (limit + parts - 1) / parts;
  return (per + kPartKeys - 1) / kPartKeys * kPartKeys;
}

// Where a decode kernel's part writes: keys per part; out and win.lse of
// part i at out + i * out_stride and win.lse + i * lse_stride (0 for one
// part); the pool rows of up to `ids` keys of a paged part staged in
// shared memory.
struct Split {
  int keys;
  long long out_stride, lse_stride;
  int ids;
};

// The prologue of a decode kernel's part: its keys' pool rows to shared
// memory (a paged part) and a block sync, or nothing (a dense part).
template <class Part>
struct StagePart {
  const Part& part;
  int tid;
  __device__ __forceinline__ void operator()() const {
    if constexpr (Part::kStagesIds) {
      part.stage(tid, kWarps * 32);
      __syncthreads();
    }
  }
};

// The decode kernels: q and out [B, win.hq, D], keys from `rows`.  One
// block of kWarps warps per (row, KV head of the window's heads) =
// blockIdx.x, query group = blockIdx.y and part of S = blockIdx.z; a block
// whose group holds none of the window's heads returns at once.  A part
// past the row's kv_len reads no key and writes out = 0, lse = -inf.
// Up to 4 queries a block, the kernel is held to 4 blocks an SM (at most
// 128 registers a thread): without the bound ptxas gave the paged instance
// 158 registers once the head window came, 3 blocks an SM instead of 4,
// and 22 % more time at the main path's shape.
template <typename T, typename TO, int GT, int NC, class Rows>
__global__ void __launch_bounds__(kWarps * 32, GT <= 4 ? 4 : 1)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ kv_len,
             TO* __restrict__ out, Rows rows, int Hkv, int G, int D, int L,
             int lp_log2, float scale, Window win, Split split) {
  extern __shared__ float smem[];
  // A split step's merge (launched as a programmatic dependent) may be
  // placed once every block has started; it waits for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int h_lo = win.head0 / G;
  const int nh = (win.head0 + win.hq - 1) / G - h_lo + 1;
  const int b = blockIdx.x / nh;
  const int h = h_lo + static_cast<int>(blockIdx.x) - b * nh;
  // The block's queries g0 .. g1 - 1 of head h's G: its group's, in the window.
  const int y0 = static_cast<int>(blockIdx.y) * GT;
  const int g0 = max(y0, win.head0 - h * G);
  const int g1 = min(min(y0 + GT, G), win.head0 + win.hq - h * G);
  if (g0 >= g1) return;
  const int len = max(0, min(kv_len[b], rows.limit()));
  const int t0 = static_cast<int>(blockIdx.z) * split.keys;
  const int n = max(0, min(len - t0, split.keys));
  // The part's keys; a paged part's keys' pool rows go to shared memory
  // after the ring and merge buffer, the page ids of each thread's first
  // two keys loaded here, ahead of q's loads, and all of them stored, and
  // the block synced, before the key loop.
  int* staged = reinterpret_cast<int*>(smem) + decode_smem_bytes(GT, D) / 4;
  const auto part = rows.part(b, t0, n, staged, split.ids, threadIdx.x, kWarps * 32);
  using Part = std::remove_const_t<decltype(part)>;
  Window w = win;
  if (w.lse != nullptr) w.lse += blockIdx.z * split.lse_stride;
  int landed = 0;
  split_body<T, GT, NC, Part, false, false>(
      q, k, v, out + blockIdx.z * split.out_stride, part,
      Tail<T>{nullptr, nullptr, nullptr, 1}, Staged{}, landed, nullptr, 0, n, true, b, h, 0, n,
      Hkv, G, g0, g1 - g0, D, L, lp_log2, scale, threadIdx.x, smem, BlockSync{}, w,
      StagePart<Part>{part, static_cast<int>(threadIdx.x)});
}

// The parts of a split decode step, merged as layers.merge_by_lse merges
// them: one warp per row and head r of rows, each lane 4 elements of D at a
// time.  ws_out [parts, rows, D] float32 (each part normalised over its
// keys) and ws_lse [parts, rows]; m = the max of the parts' lse (0 where
// all are -inf), w = e^(lse - m), out = sum w out / max(sum w, 1e-30), the
// sums taken in part order; out rounded once to TO, and, where lse is not
// null, lse = m + ln(sum w) (-inf for a row with no key).  Launched as a
// programmatic dependent of the split kernel: its blocks wait here for
// that grid's end and its writes.  Lane i holds part i's lse, and the
// first kEarly parts' first chunks are loaded with them, before m is
// known: one round trip to L2 for the common few parts.
template <typename TO>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ ws_out, const float* __restrict__ ws_lse,
             int parts, int rows, int D, TO* __restrict__ out, float* __restrict__ lse) {
  constexpr int kEarly = 8;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float neg_inf = __int_as_float(0xff800000);
  const int c0 = lane * 4;
  const auto chunk = [&](int i, int c) {
    return *reinterpret_cast<const float4*>(ws_out + (static_cast<long long>(i) * rows + r) * D + c);
  };
  float4 early[kEarly];
#pragma unroll
  for (int i = 0; i < kEarly; ++i)
    if (i < parts && c0 < D) early[i] = chunk(i, c0);
  const float mine = lane < parts ? ws_lse[static_cast<long long>(lane) * rows + r] : neg_inf;
  float m = mine;
  for (int i = lane + 32; i < parts; i += 32)
    m = fmaxf(m, ws_lse[static_cast<long long>(i) * rows + r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (m == neg_inf) m = 0.0f;
  float den = 0.0f;
  // Every lane runs every pass (the shuffles need the whole warp); a lane
  // past D loads and stores nothing.
  for (int pass = 0; pass < D; pass += 128) {
    const int c = pass + c0;
    const bool live = c < D;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    den = 0.0f;
    // Part i's weight, its lse lane i's (or, past 32 parts, read again).
    const auto add = [&](int i, const float4& x) {
      const float from_lane = __shfl_sync(0xffffffffu, mine, i & 31);
      const float w = expf((i < 32 ? from_lane : ws_lse[static_cast<long long>(i) * rows + r]) - m);
      o[0] += w * x.x;
      o[1] += w * x.y;
      o[2] += w * x.z;
      o[3] += w * x.w;
      den += w;
    };
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kEarly; ++i)
      if (i < parts) add(i, !live ? none : pass == 0 ? early[i] : chunk(i, c));
    for (int i = kEarly; i < parts; ++i) add(i, live ? chunk(i, c) : none);
    if (!live) continue;
    const float inv = fmaxf(den, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] /= inv;
    TO* dst = out + static_cast<long long>(r) * D + c;
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
      *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                 *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
  if (lse != nullptr && lane == 0) lse[r] = m + logf(den);
}

// The body's shape for D and G: calls f.run<GT, NC>(L, lp_log2) with GT
// the smallest of {1, 2, 4, 8} that holds G (8 for G > 8), NC = 2 chunks
// per lane for float32 D > 128 (else 1), L = D / E chunks per key.  D
// must be a multiple of 16 / sizeof(T) and at most 256, and every pointer
// 16-byte aligned (the wrappers check both).  Returns f's cudaError_t.
template <int NC, class F>
int with_gt(int G, const F& f, int L, int lp_log2) {
  if (G <= 1) return f.template run<1, NC>(L, lp_log2);
  if (G <= 2) return f.template run<2, NC>(L, lp_log2);
  if (G <= 4) return f.template run<4, NC>(L, lp_log2);
  return f.template run<8, NC>(L, lp_log2);
}

template <typename T, class F>
int with_shape(int G, int D, const F& f) {
  constexpr int E = 16 / sizeof(T);
  if (D <= 0 || D % E != 0 || D > 256 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = D / E;
  constexpr int NC = sizeof(T) == 4 ? 2 : 1;  // float32 D > 128: two chunks
  if (NC == 1 || L <= 32) {
    int lp_log2 = 0;
    while ((1 << lp_log2) < L) ++lp_log2;
    return with_gt<1>(G, f, L, lp_log2);
  }
  return with_gt<NC>(G, f, L, 5);
}

template <typename T, typename TO, class Rows>
struct DecodeLaunch {
  const void *q, *k, *v;
  const int32_t* kv_len;
  void* out;
  Rows rows;
  int B, Hkv, G, D;
  float scale;
  Window win;
  float* ws;
  int parts;
  cudaStream_t stream;

  template <int GT, int NC>
  int run(int L, int lp_log2) const {
    const int nh = (win.head0 + win.hq - 1) / G - win.head0 / G + 1;
    const dim3 grid(B * nh, (G + GT - 1) / GT, parts);
    const int keys = part_keys(rows.limit(), parts);
    const int body = decode_smem_bytes(GT, D);
    // The part's keys' pool rows (paged), as many as fit beside the ring and
    // merge buffer in the 48 KB a launch may ask for without an opt-in.
    const int fit = body < 48 * 1024 ? (48 * 1024 - body) / 4 : 0;
    const int ids = rows.part_ints(keys) < fit ? rows.part_ints(keys) : fit;
    const size_t smem = static_cast<size_t>(body) + sizeof(int) * static_cast<size_t>(ids);
    if (smem > 48 * 1024) {
      // A body wider than 48 KB (a larger ring or more warps) opts in.
      cudaFuncSetAttribute(split_kernel<T, TO, GT, NC, Rows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      cudaFuncSetAttribute(split_kernel<T, float, GT, NC, Rows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    if (parts == 1) {
      split_kernel<T, TO, GT, NC, Rows><<<grid, kWarps * 32, smem, stream>>>(
          qt, kt, vt, kv_len, static_cast<TO*>(out), rows, Hkv, G, D, L, lp_log2, scale, win,
          Split{keys, 0, 0, ids});
      return static_cast<int>(cudaGetLastError());
    }
    // Each part's float32 out and lse to the workspace, then the merge.
    const long long rows_hq = static_cast<long long>(B) * win.hq;
    float* ws_lse = ws + parts * rows_hq * D;
    split_kernel<T, float, GT, NC, Rows><<<grid, kWarps * 32, smem, stream>>>(
        qt, kt, vt, kv_len, ws, rows, Hkv, G, D, L, lp_log2, scale,
        Window{win.hq, win.head0, ws_lse}, Split{keys, rows_hq * D, rows_hq, ids});
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // The merge as a programmatic dependent launch: its blocks are placed
    // while the split kernel's last ones run.
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>((rows_hq * 32 + 127) / 128));
    config.blockDim = dim3(128);
    config.stream = stream;
    cudaLaunchAttribute early[1];
    early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = early;
    config.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&config, merge_kernel<TO>,
                                               static_cast<const float*>(ws),
                                               static_cast<const float*>(ws_lse), parts,
                                               static_cast<int>(rows_hq), D,
                                               static_cast<TO*>(out), win.lse));
  }
};

// A decode step on `stream` over the heads of `win` (win.hq > 0), out in
// TO, its keys split into `parts` parts of S: B * (the KV heads the heads
// span) x ceil(G / GT) x parts blocks; for parts > 1 each part's float32
// out and lse go to ws (parts * B * win.hq * (D + 1) floats: out [parts,
// B, win.hq, D], then lse [parts, B, win.hq]) and a second kernel merges
// them.  Returns the cudaError_t of the launches (0: queued).
template <typename T, typename TO, class Rows>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           void* out, Rows rows, int B, int Hkv, int G, int D, float scale,
           Window win, float* ws, int parts, cudaStream_t stream) {
  if (parts < 1 || (parts > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_shape<T>(G, D, DecodeLaunch<T, TO, Rows>{q, k, v, kv_len, out, rows, B, Hkv,
                                                       G, D, scale, win, ws, parts, stream});
}

// A decode step over all Hkv * G heads, out in T.
template <typename T, class Rows>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           void* out, Rows rows, int B, int Hkv, int G, int D, float scale, float* ws,
           int parts, cudaStream_t stream) {
  return launch<T, T>(q, k, v, kv_len, out, rows, B, Hkv, G, D, scale,
                      Window{Hkv * G, 0, nullptr}, ws, parts, stream);
}

}  // namespace decode_split
