// Batched tree-policy selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `tree_select_fwd`
// (src/repro/kernels/tree_select/tree_select.py, `_select_kernel` and
// `_scores`): for each of B rows it scores the A children of the row's
// current node under one of four tree policies and returns the first
// child with the best score.
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
// Rounding: the plain version (kernels/tree_select/ref.py) and the JAX
// reference evaluate the same float32 expression one rounded operation at
// a time.  So every product, sum, quotient and square root here is an
// explicitly rounded intrinsic, and the file is compiled with
// --fmad=false: a fused multiply-add in `n v - o r_vl` would change the
// result.  logf is CUDA's full-precision log.
//
// What bounds it: device-memory bytes.  At the main path's shape (B = 256
// trees, A = 36 actions) a wu_uct call reads 3 child tables of B*A float32
// (2 for uct), the B*A validity bytes and 2*B parent floats, and writes
// 2*B words: about 0.12 MB, 0.04 us at 3.35 TB/s.  Launch latency
// dominates by two orders of magnitude.
//
// Design: simple and right.  One warp per row; lanes stride over the A
// children keeping (best score, smallest index), then a butterfly shuffle
// reduction picks the larger score and, on equal scores, the smaller
// index.  Any B is accepted; rows need no padding.  Making it fast (several
// rows per warp at small A, fusing the gather that builds the tables) is
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kNegInf = -1e30f;

enum Kind { WU_UCT = 0, UCT = 1, TREEP = 2, TREEP_VC = 3 };

__device__ __forceinline__ float explore(float log_term, float denom,
                                         float beta) {
  float q = __fdiv_rn(__fmul_rn(2.0f, log_term), fmaxf(denom, 1e-9f));
  float e = __fmul_rn(beta, __fsqrt_rn(q));
  return denom > 0.0f ? e : INFINITY;
}

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
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together

  const float np = n_p[row];
  const float op = o_p[row];
  const float log_term = (KIND == UCT || KIND == TREEP)
                             ? logf(fmaxf(np, 1.0f))
                             : logf(fmaxf(__fadd_rn(np, op), 1.0f));
  const int64_t base = static_cast<int64_t>(row) * A;

  float best = -INFINITY;
  int idx = 0x7fffffff;
  for (int a = lane; a < A; a += 32) {
    const float n = n_c[base + a];
    const float v = v_c[base + a];
    float s;
    if (KIND == WU_UCT) {
      s = __fadd_rn(v, explore(log_term, __fadd_rn(n, o_c[base + a]), beta));
    } else if (KIND == UCT) {
      s = __fadd_rn(v, explore(log_term, n, beta));
    } else if (KIND == TREEP) {
      const float vl = vl_c ? vl_c[base + a] : 0.0f;
      s = __fadd_rn(__fsub_rn(v, vl), explore(log_term, n, beta));
    } else {  // TREEP_VC, with c = o in-flight queries
      const float c = o_c[base + a];
      const float denom = __fadd_rn(n, __fmul_rn(c, n_vl));
      const float v_adj = __fdiv_rn(
          __fsub_rn(__fmul_rn(n, v), __fmul_rn(c, r_vl)), fmaxf(denom, 1e-9f));
      s = __fadd_rn(v_adj, explore(log_term, denom, beta));
    }
    if (!valid[base + a]) s = kNegInf;
    if (a == lane || s > best) {  // a lane's indices rise: keep the first
      best = s;
      idx = a;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    act[row] = idx;
    best_out[row] = best;
  }
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
