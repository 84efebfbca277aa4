// Single-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_fwd`
// (src/repro/kernels/decode_attention/decode_attention.py, `_decode_kernel`):
// for each of B rows, the one query token's Hq heads attend the row's first
// kv_len[b] cache entries,
//
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j, i / G] / sqrt(D)) v[b, j, i / G]
//
// with G = Hq / Hkv query heads per KV head.  As in the Pallas kernel the
// softmax runs online in float32 over tiles of keys (running max m, sum l,
// accumulator acc), p and p.V stay in float32, and the output is
// acc / max(l, 1e-20): a row with kv_len = 0 reads nothing and gives zeros.
//
// What bounds it: device-memory bytes.  Every valid K/V entry is read once
// and used by G query heads, so a call moves about 2 * sum_b kv_len[b] *
// Hkv * D elements and does 4 * G flops per element pair: far below the
// card's flops per byte.
//
// Design: one block per (row, KV head).  Its G query heads go together, so
// each K/V tile is read from device memory once per row, as in the Pallas
// kernel.  The block loops over tiles of 32 keys up to the row's kv_len
// (nothing past it is read), converting them to float32 in shared memory.
// Scores: one thread per (head, key) dot product; the online softmax: one
// warp per head, one lane per key; p.V: one thread per output element.
// Inputs are float32 or bfloat16 (float32 accumulation either way).  Simple
// and right first: at the main path's shape (128 rows x 8 KV heads = 1024
// blocks, kv_len <= 160) there are enough blocks to fill the card without
// splitting the keys; vectorised loads and split-KV are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Floats of dynamic shared memory one block needs.
size_t smem_floats(int G, int D) {
  return 2 * static_cast<size_t>(G) * D        // q, acc       [G][D]
         + static_cast<size_t>(kTile) * (D + 1)  // k (padded)   [kTile][D + 1]
         + static_cast<size_t>(kTile) * D        // v            [kTile][D]
         + static_cast<size_t>(G) * kTile        // scores / p   [G][kTile]
         + 3 * static_cast<size_t>(G);           // m, l, alpha  [G]
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, int S, int Hkv, int G, int D,
                        float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + G * D;
  float* ks = acc + G * D;
  float* vs = ks + kTile * (D + 1);
  float* ps = vs + kTile * D;
  float* m = ps + G * kTile;
  float* l = m + G;
  float* alpha = l + G;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = max(0, min(kv_len[b], S));

  // The G query heads of KV head h are heads h*G .. h*G + G - 1: [G][D].
  const size_t qo = (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  for (int e = tid; e < G * D; e += blockDim.x) {
    qs[e] = to_f32(q[qo + e]);
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m[g] = kNegInf;
    l[g] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kTile) {
    const int n = min(kTile, len - k0);
    for (int e = tid; e < kTile * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      float kx = 0.0f, vx = 0.0f;
      if (j < n) {
        const size_t off =
            ((static_cast<size_t>(b) * S + k0 + j) * Hkv + h) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    for (int e = tid; e < G * kTile; e += blockDim.x) {
      const int g = e / kTile;
      const int j = e - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const float* qg = qs + g * D;
        const float* kj = ks + j * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kj[d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      const float s = ps[g * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = lane < n ? expf(s - m_new) : 0.0f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * kTile + lane] = p;
      __syncwarp();  // every lane has read m[g] before lane 0 moves it
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += blockDim.x) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pg = ps + g * kTile;
      float o = 0.0f;
      for (int j = 0; j < n; ++j) o = fmaf(pg[j], vs[j * D + d], o);
      acc[e] = acc[e] * alpha[g] + o;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += blockDim.x) {
    const int g = e / D;
    store(out + qo + e, acc[e] / fmaxf(l[g], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_len,
           void* out, int B, int S, int Hkv, int G, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), S, Hkv, G, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hkv * G, D], k and v [B, S, Hkv, D], out [B, Hkv * G, D], all
// contiguous and of one type (dtype 0: float32, 1: bfloat16); kv_len int32
// [B].  Launches on `stream` (PyTorch's current stream).  Returns the
// cudaError_t of the launch; 0 means it was queued.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int32_t* kv_len,
                                       void* out, int B, int S, int Hkv, int G,
                                       int D, float scale, int dtype,
                                       int device, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, kv_len, out, B, S, Hkv, G, D, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, kv_len, out, B, S, Hkv, G, D,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
