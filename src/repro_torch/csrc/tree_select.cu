// Tree-policy selection for Hopper (sm_90a): one level, or the whole walk.
//
// Replaces the Pallas TPU kernel `tree_select_fwd`
// (src/repro/kernels/tree_select/tree_select.py, `_select_kernel` and
// `_scores`) and the reference's lockstep traversal around it
// (`traverse_batched`, src/repro/core/batched_search.py, a `while_loop`
// that calls the kernel once per tree level).  Two entry points share one
// row body, `select_row`, which scores the A children of a node under one
// of four tree policies and returns the first child with the best score:
//
//   wu_uct    v + beta * sqrt(2 log(max(n_p + o_p, 1)) / max(n + o, 1e-9))
//   uct       v + beta * sqrt(2 log(max(n_p, 1)) / max(n, 1e-9))
//   treep     (v - vl) + (the uct term)
//   treep_vc  (n v - o r_vl) / max(n + o n_vl, 1e-9) + (the wu_uct term
//             with denominator n + o n_vl)
//
// A zero denominator scores +inf (unvisited), an invalid child -1e30.
// Ties go to the smallest index, as jnp.argmax does, also when several
// children score +inf.
//
// * `tree_select_launch`: one level, from dense [B, A] child tables (the
//   direct counterpart of `tree_select_fwd`).
// * `tree_descend_launch`: the traversal.  From the root of each of B
//   trees, walk down by the tree policy until the row stops; write the
//   stop node.  Each level splits the row's threefry key into the next key
//   and a coin key, and stops at a leaf, at max_depth, at a terminal node,
//   at a node with fewer than `width` tried children when the coin's
//   uniform draw is below `expand_coin`, or where no child is valid.
//
// Rounding: the plain versions (kernels/tree_select/ref.py) and the JAX
// reference evaluate the same float32 expression one rounded operation at
// a time.  So every product, sum, quotient and square root here is an
// explicitly rounded intrinsic, and the file is compiled with
// --fmad=false: a fused multiply-add in `n v - o r_vl` would change the
// result.  logf is CUDA's full-precision log.  Threefry-2x32 runs in
// uint32 registers and gives jax.random's bits; the coin compares the
// float32 uniform with `expand_coin` rounded to float32, as PyTorch
// compares a float32 tensor with a Python float.  So the walk's stop
// nodes equal its plain version's bit for bit.
//
// What bounds them.  One level at the main path's shape (B = 256 trees,
// A = 36 actions) reads about 0.12 MB, 0.04 us at 3.35 TB/s: launch
// latency dominates by two orders of magnitude, and the lockstep loop
// around it costs the host a launch train and a sync per level.  The walk
// rows never interact, so one warp walks one row to its end: the loop
// waits for no other row and asks the host nothing.  Its bound is the
// dependent chain of each level (the node's child ids, then the
// children's statistics, then the next node), not bytes.
//
// Design: one warp per row; lanes stride over the A children keeping
// (best score, smallest index), then the warp picks the largest score and,
// among equal scores, the smallest index.  The walk's
// blocks hold few warps (kDescendWarps) so that a few hundred rows
// spread over the 132 SMs.  Its level is one chain of two dependent
// loads: the node's row (child ids of the lane's first two slots, depth,
// flags, statistics) is loaded as soon as the node is known, and the
// children's statistics as soon as their ids arrive, before the stop test.
// The threefry draws are off that chain: only the key chain is serial, so
// each level computes three independent hashes (its coin, the next coin
// key, the key after next) while the node's row is in flight; lane 0
// computes them and broadcasts the coin.  The argmax is two warp
// reductions over order-preserving keys of the scores, not a butterfly
// of shuffles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;   // tree_select_launch
// tree_descend_launch: 1, 2 and 4 trees per block time alike at B = 256 and
// B = 1024, 8 is slower (python -m repro_torch.launch.descend_sweep).
constexpr int kDescendWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { WU_UCT = 0, UCT = 1, TREEP = 2, TREEP_VC = 3 };

__host__ __device__ constexpr bool reads_o(int kind) {
  return kind == WU_UCT || kind == TREEP_VC;
}

// One child's statistics, as the score reads them.
struct Child {
  float n, o, v, vl;
  bool valid;
};

__device__ __forceinline__ float explore(float log_term, float denom,
                                         float beta) {
  float q = __fdiv_rn(__fmul_rn(2.0f, log_term), fmaxf(denom, 1e-9f));
  float e = __fmul_rn(beta, __fsqrt_rn(q));
  return denom > 0.0f ? e : INFINITY;
}

template <int KIND>
__device__ __forceinline__ float parent_log(float np, float op) {
  return (KIND == UCT || KIND == TREEP) ? logf(fmaxf(np, 1.0f))
                                        : logf(fmaxf(__fadd_rn(np, op), 1.0f));
}

template <int KIND>
__device__ __forceinline__ float score(const Child& c, float log_term,
                                       float beta, float r_vl, float n_vl) {
  float s;
  if (KIND == WU_UCT) {
    s = __fadd_rn(c.v, explore(log_term, __fadd_rn(c.n, c.o), beta));
  } else if (KIND == UCT) {
    s = __fadd_rn(c.v, explore(log_term, c.n, beta));
  } else if (KIND == TREEP) {
    s = __fadd_rn(__fsub_rn(c.v, c.vl), explore(log_term, c.n, beta));
  } else {  // TREEP_VC, with c = o in-flight queries
    const float denom = __fadd_rn(c.n, __fmul_rn(c.o, n_vl));
    const float v_adj = __fdiv_rn(
        __fsub_rn(__fmul_rn(c.n, c.v), __fmul_rn(c.o, r_vl)), fmaxf(denom, 1e-9f));
    s = __fadd_rn(v_adj, explore(log_term, denom, beta));
  }
  return c.valid ? s : kNegInf;
}

// A score's bits as an unsigned key in the order of the scores: larger
// score, larger key; -0 and +0, which compare equal, get one key.  (Scores
// are never NaN: the statistics are finite.)
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 + 0 = +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The row body both kernels run: the warp scores children 0..A-1 of one
// node (`load(a)` gives child a) and every lane returns the best score,
// the first child index holding it, and whether any child is valid.
template <int KIND, class Load>
__device__ __forceinline__ bool select_row(const Load& load, int A, float log_term,
                                           float beta, float r_vl, float n_vl,
                                           float& best_out, int& idx_out) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  int idx = 0x7fffffff;
  bool any_valid = false;
  for (int a = lane; a < A; a += 32) {
    const Child c = load(a);
    const float s = score<KIND>(c, log_term, beta, r_vl, n_vl);
    any_valid |= c.valid;
    if (a == lane || s > best) {  // a lane's indices rise: keep the first
      best = s;
      idx = a;
    }
  }
  // The largest key, then the smallest index holding it; the score is read
  // from the lane that holds that index (child a lives in lane a % 32).
  const uint32_t key = order_key(best);
  const uint32_t top = __reduce_max_sync(kFull, key);
  idx = static_cast<int>(__reduce_min_sync(
      kFull, key == top ? static_cast<uint32_t>(idx) : 0xffffffffu));
  best = __shfl_sync(kFull, best, idx & 31);
  best_out = best;
  idx_out = idx;
  return __any_sync(kFull, any_valid);
}

// Child a of a row of the per-level kernel's dense [B, A] tables.
template <int KIND>
struct TableRow {
  const float *n, *o, *v, *vl;  // vl may be null (zeros)
  const uint8_t* valid;
  __device__ __forceinline__ Child operator()(int a) const {
    Child c;
    c.n = n[a];
    c.v = v[a];
    c.o = reads_o(KIND) ? o[a] : 0.0f;
    c.vl = (KIND == TREEP && vl) ? vl[a] : 0.0f;
    c.valid = valid[a] != 0;
    return c;
  }
};

template <int KIND>
__global__ void tree_select_kernel(const float* __restrict__ n_c,
                                   const float* __restrict__ o_c,
                                   const float* __restrict__ v_c,
                                   const float* __restrict__ vl_c,
                                   const float* __restrict__ n_p,
                                   const float* __restrict__ o_p,
                                   const uint8_t* __restrict__ valid,
                                   int32_t* __restrict__ act,
                                   float* __restrict__ best_out, int B, int A,
                                   float beta, float r_vl, float n_vl) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  const int64_t base = static_cast<int64_t>(row) * A;
  const TableRow<KIND> load{n_c + base, o_c + base, v_c + base,
                            vl_c ? vl_c + base : nullptr, valid + base};
  float best;
  int idx;
  select_row<KIND>(load, A, parent_log<KIND>(n_p[row], o_p[row]), beta, r_vl,
                   n_vl, best, idx);
  if ((threadIdx.x & 31) == 0) {
    act[row] = idx;
    best_out[row] = best;
  }
}

// ---------------------------------------------------------------------------
// The walk
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int rotation(int i, int j) {
  return (i & 1) == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                      : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// Threefry-2x32, 20 rounds: the hash of counter words (x0, x1) under key
// words (k.x, k.y), as jax.random computes it.
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// The coin of the level whose coin key is `coin_key`: 32 bits x0 ^ x1 of
// its hash of (0, 0), uniform = [1, 2) mantissa - 1, against expand_coin.
__device__ __forceinline__ bool coin_of(uint2 coin_key, float expand_coin) {
  const uint2 h = threefry2x32(coin_key, 0u, 0u);
  return __uint_as_float(((h.x ^ h.y) >> 9) | 0x3F800000u) - 1.0f < expand_coin;
}

// A row's random stream.  Level L's key k_L splits (split(key, 2)) into
// k_{L+1}, the hash of counter (0, 0), and the coin key c_L, the hash of
// (0, 1); the coin is drawn from c_L.  Only the key chain is serial, so the
// draws are pipelined: at level L the three hashes that give L's coin, c_{L+1}
// and k_{L+2} are independent, one hash deep.  Lane 0 computes them and
// broadcasts the coin.
struct Draws {
  uint2 coin_key;  // c_L
  uint2 next_key;  // k_{L+1}

  __device__ __forceinline__ explicit Draws(uint2 key)
      : coin_key(threefry2x32(key, 0u, 1u)), next_key(threefry2x32(key, 0u, 0u)) {}

  // Level L's coin; advances to level L + 1.
  __device__ __forceinline__ bool step(float expand_coin) {
    bool coin = false;
    if ((threadIdx.x & 31) == 0) {
      coin = coin_of(coin_key, expand_coin);
      coin_key = threefry2x32(next_key, 0u, 1u);
      next_key = threefry2x32(next_key, 0u, 0u);
    }
    return __shfl_sync(kFull, coin, 0);
  }
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// A node's loads that need only the node: its child ids in the lane's
// first two slots (a = lane, lane + 32; -1 past A), depth, terminal flag
// and statistics.
struct NodeRow {
  int64_t kid[2];
  int64_t depth;
  bool terminal;
  float n, o;
};

__device__ __forceinline__ NodeRow load_node(const int64_t* kids, int A, int64_t at,
                                             const int64_t* depth, const uint8_t* terminal,
                                             const float* n, const float* o) {
  const int lane = threadIdx.x & 31;
  NodeRow r;
  r.kid[0] = lane < A ? ld64(kids + lane) : -1;
  r.kid[1] = lane + 32 < A ? ld64(kids + lane + 32) : -1;
  r.depth = ld64(depth + at);
  r.terminal = __ldg(terminal + at) != 0;
  r.n = __ldg(n + at);
  r.o = __ldg(o + at);
  return r;
}

// Child `kid` of a row's [M] buffers: untried (-1) reads nothing and is
// invalid, as is a pending child.
template <int KIND>
__device__ __forceinline__ Child gather(int64_t kid, int M, const float* n,
                                        const float* o, const float* v,
                                        const float* vl, const uint8_t* pending) {
  Child c{0.0f, 0.0f, 0.0f, 0.0f, false};
  if (kid >= 0 && kid < M) {  // kid < M only fails on a malformed tree
    c.valid = __ldg(pending + kid) == 0;
    c.n = __ldg(n + kid);
    c.v = __ldg(v + kid);
    if (reads_o(KIND)) c.o = __ldg(o + kid);
    if (KIND == TREEP) c.vl = __ldg(vl + kid);
  }
  return c;
}

// Child a of a node in the walk: the lane's first two children were
// gathered ahead; a >= 64 is read here.
template <int KIND>
struct TreeRow {
  Child near0, near1;  // children lane, lane + 32
  const int64_t* kids;
  int M;
  const float *n, *o, *v, *vl;
  const uint8_t* pending;
  __device__ __forceinline__ Child operator()(int a) const {
    if (a < 32) return near0;
    if (a < 64) return near1;
    return gather<KIND>(ld64(kids + a), M, n, o, v, vl, pending);
  }
};

template <int KIND>
__global__ void tree_descend_kernel(
    const int64_t* __restrict__ children, const float* __restrict__ n,
    const float* __restrict__ o, const float* __restrict__ v,
    const float* __restrict__ vl, const uint8_t* __restrict__ pending,
    const uint8_t* __restrict__ terminal, const int64_t* __restrict__ depth,
    const int64_t* __restrict__ rngs, int64_t* __restrict__ out, int B, int M,
    int A, int64_t rng_stride, int width, int64_t max_depth, float expand_coin,
    float beta, float r_vl, float n_vl) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kDescendWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int64_t row = static_cast<int64_t>(b) * M;
  const float *nr = n + row, *orow = o + row, *vr = v + row, *vlr = vl + row;
  const uint8_t* pr = pending + row;
  // Each level's loads are issued as soon as its node is known (the root's
  // beside the key), and the level's draws run while they are in flight.
  int64_t node = 0;
  const int64_t* kids = children + row * A;
  NodeRow here = load_node(kids, A, row, depth, terminal, n, o);
  Draws draws(make_uint2(static_cast<uint32_t>(rngs[b * rng_stride]),
                         static_cast<uint32_t>(rngs[b * rng_stride + 1])));
  // Depth rises by one per step, so a tree of M nodes is walked in at most
  // M levels; the bound only guards against a malformed tree.
  for (int level = 0; level < M; ++level) {
    const bool coin = draws.step(expand_coin);
    const Child near0 = gather<KIND>(here.kid[0], M, nr, orow, vr, vlr, pr);
    const Child near1 = gather<KIND>(here.kid[1], M, nr, orow, vr, vlr, pr);
    const float log_term = parent_log<KIND>(here.n, here.o);
    int tried = (here.kid[0] >= 0) + (here.kid[1] >= 0);
    for (int a = lane + 64; a < A; a += 32) tried += ld64(kids + a) >= 0;
    const int n_tried = __reduce_add_sync(kFull, tried);
    // The stop predicate in the plain version's order; the last term, "no
    // valid child", needs the children's statistics.
    if (n_tried == 0 || here.depth >= max_depth || here.terminal ||
        (n_tried < width && coin))
      break;
    const TreeRow<KIND> load{near0, near1, kids, M, nr, orow, vr, vlr, pr};
    float best;
    int idx;
    if (!select_row<KIND>(load, A, log_term, beta, r_vl, n_vl, best, idx)) break;
    // idx is the same in every lane: the branches are uniform.
    const int64_t next =
        idx < 32   ? __shfl_sync(kFull, here.kid[0], idx)
        : idx < 64 ? __shfl_sync(kFull, here.kid[1], idx - 32)
                   : ld64(kids + idx);
    if (next < 0 || next >= M) break;  // only a malformed tree gets here
    node = next;
    kids = children + (row + node) * A;
    here = load_node(kids, A, row + node, depth, terminal, n, o);
  }
  if (lane == 0) out[b] = node;
}

template <int KIND>
cudaError_t launch_descend(dim3 grid, dim3 block, cudaStream_t s,
                           const int64_t* children, const float* n, const float* o,
                           const float* v, const float* vl, const uint8_t* pending,
                           const uint8_t* terminal, const int64_t* depth,
                           const int64_t* rngs, int64_t* out, int B, int M, int A,
                           int64_t rng_stride, int width, int64_t max_depth,
                           float expand_coin, float beta, float r_vl, float n_vl) {
  tree_descend_kernel<KIND><<<grid, block, 0, s>>>(
      children, n, o, v, vl, pending, terminal, depth, rngs, out, B, M, A,
      rng_stride, width, max_depth, expand_coin, beta, r_vl, n_vl);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream).  `vl_c` may be null
// (zeros).  Returns the cudaError_t of the launch; 0 means it was queued.
extern "C" int tree_select_launch(const float* n_c, const float* o_c,
                                  const float* v_c, const float* vl_c,
                                  const float* n_p, const float* o_p,
                                  const uint8_t* valid, int32_t* act,
                                  float* best, int B, int A, int kind,
                                  float beta, float r_vl, float n_vl,
                                  int device, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case WU_UCT:
      tree_select_kernel<WU_UCT><<<grid, block, 0, s>>>(
          n_c, o_c, v_c, vl_c, n_p, o_p, valid, act, best, B, A, beta, r_vl, n_vl);
      break;
    case UCT:
      tree_select_kernel<UCT><<<grid, block, 0, s>>>(
          n_c, o_c, v_c, vl_c, n_p, o_p, valid, act, best, B, A, beta, r_vl, n_vl);
      break;
    case TREEP:
      tree_select_kernel<TREEP><<<grid, block, 0, s>>>(
          n_c, o_c, v_c, vl_c, n_p, o_p, valid, act, best, B, A, beta, r_vl, n_vl);
      break;
    case TREEP_VC:
      tree_select_kernel<TREEP_VC><<<grid, block, 0, s>>>(
          n_c, o_c, v_c, vl_c, n_p, o_p, valid, act, best, B, A, beta, r_vl, n_vl);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk of B trees of capacity M and A actions, one warp per tree,
// kDescendWarps trees per block.  `children` is [B, M, A], the
// statistics and flags [B, M], `rngs` rows of two key words `rng_stride`
// elements apart, `out` [B].  All contiguous but `rngs`.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int tree_descend_launch(const int64_t* children, const float* n,
                                   const float* o, const float* v, const float* vl,
                                   const uint8_t* pending, const uint8_t* terminal,
                                   const int64_t* depth, const int64_t* rngs,
                                   int64_t* out, int B, int M, int A,
                                   int64_t rng_stride, int width, int64_t max_depth,
                                   float expand_coin, int kind, float beta,
                                   float r_vl, float n_vl, int device, void* stream) {
  if (B <= 0 || M <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32 * kDescendWarps);
  const dim3 grid((B + kDescendWarps - 1) / kDescendWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case WU_UCT:
      err = launch_descend<WU_UCT>(grid, block, s, children, n, o, v, vl, pending,
                                   terminal, depth, rngs, out, B, M, A, rng_stride,
                                   width, max_depth, expand_coin, beta, r_vl, n_vl);
      break;
    case UCT:
      err = launch_descend<UCT>(grid, block, s, children, n, o, v, vl, pending,
                                terminal, depth, rngs, out, B, M, A, rng_stride,
                                width, max_depth, expand_coin, beta, r_vl, n_vl);
      break;
    case TREEP:
      err = launch_descend<TREEP>(grid, block, s, children, n, o, v, vl, pending,
                                  terminal, depth, rngs, out, B, M, A, rng_stride,
                                  width, max_depth, expand_coin, beta, r_vl, n_vl);
      break;
    case TREEP_VC:
      err = launch_descend<TREEP_VC>(grid, block, s, children, n, o, v, vl, pending,
                                     terminal, depth, rngs, out, B, M, A, rng_stride,
                                     width, max_depth, expand_coin, beta, r_vl, n_vl);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
