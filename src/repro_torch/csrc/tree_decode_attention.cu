// Tree-batched speculative decode attention, dense and paged prefix, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `tree_decode_attention_fwd` and
// `paged_tree_decode_attention_fwd`
// (src/repro/kernels/decode_attention/tree_decode_attention.py, bodies
// `_tree_decode_kernel` and `_paged_tree_decode_kernel`).  Each of B rows
// carries A candidate next tokens, all at position kv_len[b]: candidate a's
// query heads attend the row's first kv_len[b] prefix keys (a dense cache
// [B, S, Hkv, D], or a pool [P, bs, Hkv, D] through page_table [B, n_pages])
// plus the speculative tail entries j of k_spec/v_spec [B, A, Hkv, D] that
// tree_mask[a, j] allows (the identity for a flat frontier: each candidate
// sees its own K/V only).  The tail lives outside the cache; nothing is
// written but the output.  Scores, p and p.V are float32; a query with
// nothing to attend gives zeros.
//
// What bounds it: not the bytes (the prefix once per (row, KV head) for
// all A candidates, the point of the TPU kernel, 4 * A * G flops per
// prefix K/V element pair) but the issue of the CUDA cores' instructions.
// Each candidate runs the decode kernels' body, whose rounding the tree
// kernels share (which rules out the tensor cores here); its key loop
// issues ~127 warp instructions per key, candidate and KV head at bf16
// D = 128, G = 4 (1017 per step of 8 keys: 260 FMAs, 80 shuffles, the
// rest bf16 widening, softmax and bookkeeping; `attention_sweep` prints
// the mix).
//
// Design: one block per (row, KV head) and query group (blockIdx.y, GT of
// the G query heads, as the decode kernels) owns all A candidates
// (kCandidates = 32 >= A; a smaller kCandidates splits them into shares of
// that many, one block each, and the prefix is then read once per share).
// The block copies the row's first min(kv_len, cap) prefix keys of K and V
// into shared memory with 16-byte cp.async, once, and after them the row's
// A tail entries and a row of zeros: cap is what fits in kSmemBudget
// (110 KB, so two blocks share an SM) beside those and the groups' merge
// buffers, 178 keys at bf16 D = 128, G = 4 and A = 8 (177 paged, 84 at
// float32), and keys past it are read from device memory by the body as
// the decode kernels read them: a long cache is right and only slower.  The paged
// entry point looks each live page id up once per block (clamped into
// [0, P - 1]) and never reads a page past the row's live ones.  The copy
// lands in chunks of 32 keys, each completing an mbarrier, so the
// candidates start on the first chunk while later ones arrive (kOverlap).
// kGroups = 2 groups of kWarps = 4 warps then walk alternate candidates
// (a = grp, grp + 2, ...), each running the body over the staged keys
// with its own merge buffer and named barrier: at ~100 KB and 8 warps per
// block, two blocks and 16 warps share an SM.  With the whole prefix
// staged, every step reads each key's chunks from shared memory at use:
// the key's prefix row, its tail entry's row, or the zero row past the
// candidate's keys.  Every loop around the body counts alike in all
// warps (rounds of kGroups candidates, a key bound from a uniform-register
// reduction): a trip count that depends on the thread's group would make
// ptxas guard every shuffle of the body with WARPSYNC.  Candidate a's
// logical keys are the row's kv_len prefix keys, then the tail entries j
// it sees in order of j (A <= 32), so with the frontier's identity mask
// (a null mask pointer) it computes exactly what decode_attention computes
// over the cache with entry a appended, rounding for rounding: a frontier
// forward and the decode steps of the same candidates agree.  D is a
// multiple of 16 bytes' worth of elements, at most 256.

#include "decode_split.cuh"

namespace {

using decode_split::kWarps;

// Groups of kWarps warps per block, walking alternate candidates.
constexpr int kGroups = 2;
// Candidates per block: at most 32 (A <= 32) puts all of a row's in one.
constexpr int kCandidates = 32;
// Candidates start on the staged keys as each chunk lands; false: the
// whole copy lands before any key is read.
constexpr bool kOverlap = true;
constexpr int kChunkKeys = 32;
constexpr int kMaxChunks = 16;
// Dynamic shared memory of one block: two blocks fit an SM's 228 KB.
constexpr size_t kSmemBudget = 110 * 1024;
constexpr int kThreads = kGroups * kWarps * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Phase 0 of the mbarrier at `bar` completes when all kThreads threads'
// cp.async issued before their arrive() have landed.
__device__ __forceinline__ void barrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar),
               "r"(kThreads)
               : "memory");
}
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Barrier of one group's kWarps * 32 threads: ids 1 .. 4 (0 is
// __syncthreads); constant ids, so that ptxas reserves five barriers.
__device__ __forceinline__ void group_sync(int grp) {
  static_assert(kGroups <= 4, "one named barrier per group");
  switch (grp) {
    case 0:
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
      break;
    case 1:
      asm volatile("bar.sync 2, %0;\n" ::"n"(kWarps * 32) : "memory");
      break;
    case 2:
      asm volatile("bar.sync 3, %0;\n" ::"n"(kWarps * 32) : "memory");
      break;
    default:
      asm volatile("bar.sync 4, %0;\n" ::"n"(kWarps * 32) : "memory");
      break;
  }
}

struct GroupSync {
  int grp;
  __device__ __forceinline__ void operator()() const { group_sync(grp); }
};

// q and out [B, A, Hkv * G, D]; the prefix from `rows`, of which the first
// min(kv_len, n_cap) keys are staged.  blockIdx.x = (b * Hkv + h) *
// shares + share, blockIdx.y = query group.  Dynamic shared memory: K and
// V rows of n_cap keys, the A tail entries and a zero row; kGroups merge
// buffers; the staged keys' page ids.  At most 128 registers a thread
// where GT <= 4, so that the blocks that fit by shared memory also fit by
// registers.
template <typename T, int GT, int NC, class Rows>
__global__ void __launch_bounds__(kThreads, GT <= 4 ? 4 / kGroups : 1)
tree_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int32_t* __restrict__ kv_len,
            T* __restrict__ out, Rows rows, decode_split::Tail<T> tail,
            int n_cap, int Hkv, int G, int D, int L, int lp_log2,
            float scale) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ unsigned char visible[32][32];  // [candidate][i]: i-th entry seen
  __shared__ int n_visible[32];

  const int A = tail.A;
  const int per_block = min(A, kCandidates);
  const int shares = (A + per_block - 1) / per_block;
  const int bh = blockIdx.x / shares;
  const int a0 = (blockIdx.x - bh * shares) * per_block;
  const int a1 = min(A, a0 + per_block);
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int g0 = blockIdx.y * GT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(0, min(kv_len[b], rows.limit()));
  const int n_st = min(len, n_cap);
  const int chunk = kOverlap ? max(kChunkKeys, (n_st + kMaxChunks - 1) / kMaxChunks)
                             : max(n_st, 1);
  const int n_chunks = max(1, (n_st + chunk - 1) / chunk);  // the tail lands with chunk 0
  const int n_rows = n_cap + A + 1;  // the prefix, the tail, a zero row

  T* sk = reinterpret_cast<T*>(staged);
  T* sv = sk + static_cast<size_t>(n_rows) * D;
  float* merge = reinterpret_cast<float*>(sv + static_cast<size_t>(n_rows) * D);
  const int merge_floats = kWarps * GT * (D + 2);
  int* ids = reinterpret_cast<int*>(merge + kGroups * merge_floats);

  // The chunks' barriers; each candidate's visible tail entries, in order
  // of j (written by warp c % 8), and the most any candidate sees, in a
  // uniform register (REDUX), for the key loop's bound; the staged keys'
  // page ids (paged), each looked up once.
  if (tid < n_chunks) barrier_init(smem_addr(bars + tid));
  int seen_here = 0;
  for (int c = 0; c < A; ++c) {
    const bool sees =
        lane < A && (tail.mask ? tail.mask[c * A + lane] != 0 : lane == c);
    const unsigned seen = __ballot_sync(0xffffffffu, sees);
    if (lane == c) seen_here = __popc(seen);
    if (c % (kThreads / 32) == warp) {
      if (sees) visible[c][__popc(seen & ((1u << lane) - 1u))] = lane;
      if (lane == 0) n_visible[c] = __popc(seen);
    }
  }
  const int n_bound = len + __reduce_max_sync(0xffffffffu, seen_here);
  for (int i = tid; i < rows.ids(n_st); i += kThreads) ids[i] = rows.page(b, i);
  for (int i = tid; i < 2 * L; i += kThreads)
    reinterpret_cast<uint4*>((i < L ? sk : sv) + static_cast<size_t>(n_cap + A) * D)[i % L] =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // The copy: the A tail entries, then the prefix chunk by chunk, 2 L
  // 16-byte pieces per key (K, then V); each thread's pieces of chunk c
  // (the tail's with chunk 0) arrive on bars[c] once they have landed.
  const int per_key = 2 * L;
  for (int i = tid; i < A * per_key; i += kThreads) {
    const int j = i / per_key;
    const int r = i - j * per_key;
    const bool is_v = r >= L;
    const int ch = (is_v ? r - L : r) * E;
    const long long off = ((static_cast<long long>(b) * A + j) * Hkv + h) *
                          static_cast<long long>(D);
    cp_async16(smem_addr((is_v ? sv : sk) + static_cast<size_t>(n_cap + j) * D + ch),
               (is_v ? tail.v : tail.k) + off + ch);
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    const int pieces = (min(n_st, t0 + chunk) - t0) * per_key;
    for (int i = tid; i < pieces; i += kThreads) {
      const int t = t0 + i / per_key;
      const int r = i - (t - t0) * per_key;
      const bool is_v = r >= L;
      const int ch = (is_v ? r - L : r) * E;
      const long long off = rows.staged_offset(ids, b, h, t, Hkv, D);
      cp_async16(smem_addr((is_v ? sv : sk) + static_cast<size_t>(t) * D + ch),
                 (is_v ? v : k) + off + ch);
    }
    arrive(smem_addr(bars + c));
  }

  // Each group runs the decode body for its candidates, in rounds that
  // every warp counts alike (a group past the last candidate idles through
  // its last round).
  const int grp = warp / kWarps;
  const decode_split::Staged st{smem_addr(sk), smem_addr(sv), smem_addr(bars),
                                n_st, chunk, n_chunks, n_cap, n_cap + A};
  int landed = 0;
  const int rounds = (per_block + kGroups - 1) / kGroups;
  for (int r = 0; r < rounds; ++r) {
    const int a = a0 + r * kGroups + grp;
    const bool active = a < a1;
    const int ac = active ? a : a0;
    decode_split::split_body<T, GT, NC, Rows, true, true>(
        q, k, v, out, rows, tail, st, landed, visible[ac],
        active ? n_visible[ac] : -len, n_bound, active, b, h, ac, len, Hkv, G,
        g0, min(GT, G - g0), D, L, lp_log2, scale, tid - grp * kWarps * 32,
        merge + grp * merge_floats, GroupSync{grp});
    group_sync(grp);  // the group's merge buffer is free again
  }
  // A thread that read no key (no chunk waited on) may still have copies
  // in flight.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, class Rows>
struct TreeLaunch {
  const void *q, *k, *v;
  const int32_t* kv_len;
  void* out;
  Rows rows;
  decode_split::Tail<T> tail;
  int B, Hkv, G, D;
  float scale;
  cudaStream_t stream;

  template <int GT, int NC>
  int run(int L, int lp_log2) const {
    // cap: the prefix keys whose K, V (and, paged, at most one page id
    // each) fit the budget beside the merge buffers, the tail and the zero
    // row.
    const size_t merge = kGroups * decode_split::smem_bytes(GT, D);
    const size_t row_pair = 2 * sizeof(T) * D;
    const size_t fixed = merge + row_pair * (tail.A + 1) + 16;
    const size_t per_key = row_pair + (rows.ids(1) > 0 ? 4 : 0);
    const long long cap =
        fixed < kSmemBudget ? static_cast<long long>((kSmemBudget - fixed) / per_key) : 0;
    const int n_cap = static_cast<int>(cap < rows.limit() ? cap : rows.limit());
    const size_t ids = (sizeof(int32_t) * rows.ids(n_cap) + 15) / 16 * 16;
    const size_t smem = row_pair * (n_cap + tail.A + 1) + merge + ids;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          tree_kernel<T, GT, NC, Rows>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int per_block = tail.A < kCandidates ? tail.A : kCandidates;
    const dim3 grid(B * Hkv * ((tail.A + per_block - 1) / per_block),
                    (G + GT - 1) / GT);
    tree_kernel<T, GT, NC, Rows><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, static_cast<T*>(out), rows, tail,
        n_cap, Hkv, G, D, L, lp_log2, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <class Rows>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* kv_len, const void* k_spec, const void* v_spec,
             const int32_t* mask, void* out, Rows rows, int B, int A, int Hkv,
             int G, int D, float scale, int dtype, int device, void* stream) {
  if (B <= 0 || A <= 0 || A > 32 || Hkv <= 0 || G <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const decode_split::Tail<float> tail{static_cast<const float*>(k_spec),
                                           static_cast<const float*>(v_spec),
                                           mask, A};
      return decode_split::with_shape<float>(
          G, D, TreeLaunch<float, Rows>{q, k, v, kv_len, out, rows, tail, B,
                                        Hkv, G, D, scale, s});
    }
    case 1: {
      const decode_split::Tail<__nv_bfloat16> tail{
          static_cast<const __nv_bfloat16*>(k_spec),
          static_cast<const __nv_bfloat16*>(v_spec), mask, A};
      return decode_split::with_shape<__nv_bfloat16>(
          G, D, TreeLaunch<__nv_bfloat16, Rows>{q, k, v, kv_len, out, rows,
                                                tail, B, Hkv, G, D, scale, s});
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, A, Hkv * G, D], k_cache and v_cache [B, S, Hkv, D], k_spec and
// v_spec [B, A, Hkv, D], out [B, A, Hkv * G, D], all contiguous, of one
// type (dtype 0: float32, 1: bfloat16) and 16-byte aligned; kv_len int32
// [B]; mask int32 [A, A] (nonzero: attend), or null for the identity.
// Returns the cudaError_t of the launch.
extern "C" int tree_decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_spec, const void* v_spec, const int32_t* kv_len,
    const int32_t* mask, void* out, int B, int A, int S, int Hkv, int G,
    int D, float scale, int dtype, int device, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k_cache, v_cache, kv_len, k_spec, v_spec, mask, out,
                  decode_tiles::DenseRows{S}, B, A, Hkv, G, D, scale, dtype,
                  device, stream);
}

// As tree_decode_attention_launch, with the prefix in pool_k and pool_v
// [P, bs, Hkv, D] addressed through table int32 [B, n_pages].
extern "C" int paged_tree_decode_attention_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const int32_t* table, const void* k_spec, const void* v_spec,
    const int32_t* kv_len, const int32_t* mask, void* out, int B, int A,
    int P, int bs, int n_pages, int Hkv, int G, int D, float scale, int dtype,
    int device, void* stream) {
  if (P <= 0 || bs <= 0 || n_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, pool_k, pool_v, kv_len, k_spec, v_spec, mask, out,
                  decode_tiles::PagedRows{table, n_pages, P, bs}, B, A, Hkv,
                  G, D, scale, dtype, device, stream);
}
