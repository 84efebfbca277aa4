// Backward of the causal GQA flash attention (csrc/flash_attention.cu) for
// Hopper (sm_90a).
//
// The Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py) has no backward:
// the JAX package trains through XLA's differentiation of its plain
// chunked attention.  The port runs the forward kernel on every cache-free
// causal path on the card, so training there needs this gradient.  For q
// [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], G = Hq / Hkv, the forward's output
// o and its row log-sum-exp lse [B, Hq, Sq] (natural log of the scaled
// scores), and the output gradient do:
//
//   p[t, j]  = exp(scale * q[t] . k[j] - lse[t])     (0 where j > t, causal)
//   D[t]     = sum_d do[t, d] o[t, d]
//   ds[t, j] = p[t, j] (do[t] . v[j] - D[t])
//   dv[j]    = sum_{t, heads of j's KV head} p[t, j] do[t]
//   dk[j]    = scale * sum_{t, heads} ds[t, j] q[t]
//   dq[t]    = scale * sum_j ds[t, j] k[j]
//
// all in float32 from the inputs' type, rounded once to it at the end.
//
// What bounds it: at the training shape (8 x 512 tokens, 32/8 heads,
// D = 128, bf16, causal) the five products take 4.3e10 flops, 43 us on the
// bf16 tensor cores, and reading q, k, v, o, do and writing dq, dk, dv
// moves ~168 MB, 50 us at 3.35 TB/s: bytes bound it.  This first kernel
// is the simple design that is right: CUDA-core float32 FMAs from shared
// memory, three launches, no atomics.
//
// * `bwd_delta_kernel`: D for every row, one warp a row.
// * `bwd_dkdv_kernel`: one block per (batch, KV head, tile of 32 keys).
//   Its K and V tiles stay in shared memory while it loops over the G query
//   heads of the KV head and the query tiles at or after the key tile
//   (causal), so the GQA sum over heads stays in the block's registers.
// * `bwd_dq_kernel`: one block per (batch, query head, tile of 32 rows),
//   looping over the key tiles the rows can see.
//
// Both tile kernels recompute p and ds for a 32 x 32 tile the same way:
// each of the 4 warps takes 8 rows, each lane one key, and walks D four
// values at a time (rows broadcast from shared memory, the lane's key row
// padded by 4 floats so 16-byte loads of 8 lanes fall on distinct banks).
// ds goes to shared memory (rows padded to 33) for the products that
// follow, in which a lane owns a key (dk, dv) or a row (dq) and a warp a
// quarter of D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                 // rows of a query tile, keys of a key tile
constexpr int kRows = kTile / kWarps;     // rows per warp in the score step
constexpr int kPad = kTile + 1;           // row stride of the p / ds tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Shared memory of both tile kernels: the q, do, k and v tiles in float32
// ([kTile][D + 4] each), the p and ds tiles ([kTile][kPad]) and the rows'
// lse and D.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kTile) * (D + 4) +
                          2 * static_cast<size_t>(kTile) * kPad + 2 * kTile);
}

// Rows [r0, r0 + kTile) of a tensor whose rows are `stride` elements apart
// -> dst [kTile][D + 4] in float32; rows at or past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n) x = load4(src + (r0 + r) * stride + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

// lse and D of query rows [q0, q0 + kTile) of one (batch, head): 0 past Sq.
__device__ __forceinline__ void load_rows(float* lse_s, float* dlt_s,
                                          const float* lse, const float* dlt,
                                          long long bh, int q0, int Sq) {
  if (threadIdx.x < kTile) {
    const int t = q0 + threadIdx.x;
    const bool in = t < Sq;
    lse_s[threadIdx.x] = in ? lse[bh * Sq + t] : 0.0f;
    dlt_s[threadIdx.x] = in ? dlt[bh * Sq + t] : 0.0f;
  }
}

// p and ds of the tile (query rows q0 + i, keys k0 + j) into p_s / ds_s
// ([kTile][kPad]; p_s may be null): the warp's 8 rows against the lane's
// key.  Masked entries (causal future, rows past Sq, keys past Sk) are 0.
template <int D>
__device__ __forceinline__ void tile_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* dlt_s, float* p_s, float* ds_s, int q0,
    int k0, int Sq, int Sk, int causal, float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
  const float* kj = ks + lane * (D + 4);
  const float* vj = vs + lane * (D + 4);
  const float* q0p = qs + warp * kRows * (D + 4);
  const float* o0p = dos + warp * kRows * (D + 4);
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = load4(kj + d);
    const float4 v4 = load4(vj + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 q4 = load4(q0p + r * (D + 4) + d);
      const float4 o4 = load4(o0p + r * (D + 4) + d);
      s[r] = fmaf(q4.x, k4.x, s[r]);
      s[r] = fmaf(q4.y, k4.y, s[r]);
      s[r] = fmaf(q4.z, k4.z, s[r]);
      s[r] = fmaf(q4.w, k4.w, s[r]);
      dp[r] = fmaf(o4.x, v4.x, dp[r]);
      dp[r] = fmaf(o4.y, v4.y, dp[r]);
      dp[r] = fmaf(o4.z, v4.z, dp[r]);
      dp[r] = fmaf(o4.w, v4.w, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp * kRows + r;
    const int t = q0 + i;
    const bool valid = t < Sq && key < Sk && (!causal || key <= t);
    const float p = valid ? expf(s[r] * scale - lse_s[i]) : 0.0f;
    if (p_s != nullptr) p_s[i * kPad + lane] = p;
    ds_s[i * kPad + lane] = p * (dp[r] - dlt_s[i]);
  }
}

// D[b, h, t] = sum_d do[b, t, h, d] o[b, t, h, d]: one warp per row, rows
// in memory order (b, t, h).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ dlt, int Sq, int Hq, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bt = row / Hq;
    const int t = static_cast<int>(bt % Sq);
    const long long b = bt / Sq;
    dlt[(b * Hq + h) * Sq + t] = acc;
  }
}

// dk, dv of one (batch, KV head, key tile).  Key tiles in order, so the
// causal tiles with the most query tiles start first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dlt,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
                int Hkv, int causal, float scale) {
  constexpr int kDW = D / kWarps;  // dims per warp in the products
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 4);
  float* ks = dos + kTile * (D + 4);
  float* vs = ks + kTile * (D + 4);
  float* p_s = vs + kTile * (D + 4);
  float* ds_s = p_s + kTile * kPad;
  float* lse_s = ds_s + kTile * kPad;
  float* dlt_s = lse_s + kTile;

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  load_tile<T, D>(ks, k + kv_off, kv_stride, k0, Sk);
  load_tile<T, D>(vs, v + kv_off, kv_stride, k0, Sk);

  float dk_acc[kDW], dv_acc[kDW];
#pragma unroll
  for (int c = 0; c < kDW; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  // Causal: rows before k0 see none of the tile's keys.
  const int q_first = causal ? (k0 / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long bh = static_cast<long long>(b) * Hq + h;
    const long long q_off = (static_cast<long long>(b) * Sq * Hq + h) * D;
    for (int q0 = q_first; q0 < Sq; q0 += kTile) {
      __syncthreads();  // the previous tile's products are done with qs, dos, p, ds
      load_tile<T, D>(qs, q + q_off, q_stride, q0, Sq);
      load_tile<T, D>(dos, dout + q_off, q_stride, q0, Sq);
      load_rows(lse_s, dlt_s, lse, dlt, bh, q0, Sq);
      __syncthreads();
      tile_scores<D>(qs, dos, ks, vs, lse_s, dlt_s, p_s, ds_s, q0, k0, Sq, Sk,
                     causal, scale);
      __syncthreads();
      // dv[j] += sum_i p[i, j] do[i], dk[j] += sum_i ds[i, j] q[i] for the
      // lane's key j over the warp's dims.
      const float* qd = qs + warp * kDW;
      const float* od = dos + warp * kDW;
      const int rows = min(kTile, Sq - q0);
      for (int i = 0; i < rows; ++i) {
        const float p = p_s[i * kPad + lane];
        const float ds = ds_s[i * kPad + lane];
#pragma unroll
        for (int c = 0; c < kDW; c += 4) {
          const float4 o4 = load4(od + i * (D + 4) + c);
          const float4 q4 = load4(qd + i * (D + 4) + c);
          dv_acc[c] = fmaf(p, o4.x, dv_acc[c]);
          dv_acc[c + 1] = fmaf(p, o4.y, dv_acc[c + 1]);
          dv_acc[c + 2] = fmaf(p, o4.z, dv_acc[c + 2]);
          dv_acc[c + 3] = fmaf(p, o4.w, dv_acc[c + 3]);
          dk_acc[c] = fmaf(ds, q4.x, dk_acc[c]);
          dk_acc[c + 1] = fmaf(ds, q4.y, dk_acc[c + 1]);
          dk_acc[c + 2] = fmaf(ds, q4.z, dk_acc[c + 2]);
          dk_acc[c + 3] = fmaf(ds, q4.w, dk_acc[c + 3]);
        }
      }
    }
  }

  const int key = k0 + lane;
  if (key < Sk) {
    T* dkr = dk + kv_off + key * kv_stride + warp * kDW;
    T* dvr = dv + kv_off + key * kv_stride + warp * kDW;
#pragma unroll
    for (int c = 0; c < kDW; c += 4) {
      store4(dkr + c, make_float4(dk_acc[c] * scale, dk_acc[c + 1] * scale,
                                  dk_acc[c + 2] * scale, dk_acc[c + 3] * scale));
      store4(dvr + c, make_float4(dv_acc[c], dv_acc[c + 1], dv_acc[c + 2],
                                  dv_acc[c + 3]));
    }
  }
}

// dq of one (batch, query head, query tile).  Tile index reversed, so the
// causal tiles that see the most keys start first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlt,
              T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
              float scale) {
  constexpr int kDW = D / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 4);
  float* ks = dos + kTile * (D + 4);
  float* vs = ks + kTile * (D + 4);
  float* ds_s = vs + kTile * (D + 4) + kTile * kPad;
  float* lse_s = ds_s + kTile * kPad;
  float* dlt_s = lse_s + kTile;

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x - b * Hq;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk * Hkv + hk) * D;
  const long long q_off = (static_cast<long long>(b) * Sq * Hq + h) * D;
  load_tile<T, D>(qs, q + q_off, q_stride, q0, Sq);
  load_tile<T, D>(dos, dout + q_off, q_stride, q0, Sq);
  load_rows(lse_s, dlt_s, lse, dlt, static_cast<long long>(b) * Hq + h, q0, Sq);

  float dq_acc[kDW];
#pragma unroll
  for (int c = 0; c < kDW; ++c) dq_acc[c] = 0.0f;

  // Causal: keys past the tile's last row are in every row's future.
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's product is done with ks, ds
    load_tile<T, D>(ks, k + kv_off, kv_stride, k0, Sk);
    load_tile<T, D>(vs, v + kv_off, kv_stride, k0, Sk);
    __syncthreads();
    tile_scores<D>(qs, dos, ks, vs, lse_s, dlt_s, nullptr, ds_s, q0, k0, Sq,
                   Sk, causal, scale);
    __syncthreads();
    // dq[i] += sum_j ds[i, j] k[j] for the lane's row i over the warp's dims.
    const float* kd = ks + warp * kDW;
    const int keys = min(kTile, Sk - k0);
    for (int j = 0; j < keys; ++j) {
      const float ds = ds_s[lane * kPad + j];
#pragma unroll
      for (int c = 0; c < kDW; c += 4) {
        const float4 k4 = load4(kd + j * (D + 4) + c);
        dq_acc[c] = fmaf(ds, k4.x, dq_acc[c]);
        dq_acc[c + 1] = fmaf(ds, k4.y, dq_acc[c + 1]);
        dq_acc[c + 2] = fmaf(ds, k4.z, dq_acc[c + 2]);
        dq_acc[c + 3] = fmaf(ds, k4.w, dq_acc[c + 3]);
      }
    }
  }

  const int t = q0 + lane;
  if (t < Sq) {
    T* dqr = dq + q_off + t * q_stride + warp * kDW;
#pragma unroll
    for (int c = 0; c < kDW; c += 4)
      store4(dqr + c, make_float4(dq_acc[c] * scale, dq_acc[c + 1] * scale,
                                  dq_acc[c + 2] * scale, dq_acc[c + 3] * scale));
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dlt, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  int err = allow_smem(bwd_dkdv_kernel<T, D>, smem);
  if (err == 0) err = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (err != 0) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), dot, dlt, Sq, Hq, rows);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 kv_grid(B * Hkv, (Sk + kTile - 1) / kTile);
  bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dlt, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, Hkv, causal, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 q_grid(B * Hq, (Sq + kTile - 1) / kTile);
  bwd_dq_kernel<T, D><<<q_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dlt, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* dlt, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
             int causal, float scale, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch<float, D>(q, k, v, out, dout, lse, dlt, dq, dk, dv, B, Sq,
                              Sk, Hq, Hkv, causal, scale, s);
    case 1:
      return launch<bf16, D>(q, k, v, out, dout, lse, dlt, dq, dk, dv, B, Sq,
                             Sk, Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out, dout and dq [B, Sq, Hq, D], k, v, dk and dv [B, Sk, Hkv, D], all
// contiguous, of one type (dtype 0: float32, 1: bfloat16) and 16-byte
// aligned; lse (the forward's) and the scratch `dlt` float32 [B, Hq, Sq];
// D in {16, 32, 64, 112, 128}, Hq a multiple of Hkv.  Launches three
// kernels on `stream` (PyTorch's current stream); returns the first
// cudaError_t, 0 when all three were queued.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dlt, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, float scale,
    int dtype, int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(dlt);
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 32:
      return launch_d<32>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 64:
      return launch_d<64>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 112:
      return launch_d<112>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    case 128:
      return launch_d<128>(q, k, v, out, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
