// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py, `_fa_kernel`):
//
//   out[b, t, i] = sum_{j <= t} softmax_j(q[b, t, i] . k[b, j, i / G] / sqrt(D))
//                  v[b, j, i / G]
//
// for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D], G = Hq / Hkv (query and key
// positions both count from 0; `causal = 0` drops the j <= t mask).  As in
// the Pallas kernel the softmax runs online in float32 (running max m, sum
// l, accumulator acc), p and p.V stay in float32, keys in a query's future
// are never visited, and the output is acc / max(l, 1e-20).
//
// What bounds it: operations.  Causal attention over S positions does about
// 2 * S^2 * D flops per (batch, query head) on 2 * S * D elements of K and
// V; at S = 160 that is well above the card's flops per byte, so this
// CUDA-core kernel (67 TFLOP/s float32 peak, not the tensor cores' 989 in
// bf16) is bound by its arithmetic and by shared-memory traffic.
//
// Design: one block per (batch * query head, tile of 32 queries), KV head =
// query head / G.  Four warps own eight query rows each.  The block walks
// tiles of 32 keys up to its causal frontier, converting them to float32 in
// shared memory (K row-padded so the 32 lanes' reads hit 32 banks); the last
// tile may be ragged and is masked.  For one query row a warp computes one
// key's score per lane, updates m and l with shuffles, and accumulates p.V
// with each lane owning D / 32 output elements in registers.  Any S and any
// B are accepted.  Simple FMA loops first: the tensor-core (mma / wgmma)
// and TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * D          // q
                          + static_cast<size_t>(kBlockK) * (D + 1)  // k
                          + static_cast<size_t>(kBlockK) * D);      // v
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, int causal, float scale) {
  constexpr int kPerLane = (D + 31) / 32;  // output elements per lane
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;         // [kBlockK][D + 1]
  float* vs = ks + kBlockK * (D + 1);   // [kBlockK][D]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hq = bh - b * Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < kBlockQ * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int t = q0 + r;
    qs[e] = t < Sq
        ? to_f32(q[((static_cast<size_t>(b) * Sq + t) * Hq + hq) * D + d])
        : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int n = min(kBlockK, Sk - k0);
    __syncthreads();  // the previous tile (and the q load) are done with
    for (int e = tid; e < kBlockK * D; e += blockDim.x) {
      const int j = e / D;
      const int d = e - j * D;
      float kx = 0.0f, vx = 0.0f;
      if (j < n) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + k0 + j) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int t = q0 + r;
      // Warp-uniform skips: a row past the sequence, or a tile wholly in
      // this row's future (the Pallas kernel's masked update is a no-op).
      if (t >= Sq || (causal && k0 > t)) continue;
      const int key = k0 + lane;
      const bool valid = lane < n && (!causal || key <= t);
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + r * D;
        const float* kj = ks + lane * (D + 1);
        float dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        s = dot * scale;
      }
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float a = expf(m[i] - m_new);
      l[i] = l[i] * a + sum;
      m[i] = m_new;

      float pv[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) pv[c] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < D) pv[c] = fmaf(pj, vs[j * D + d], pv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc[i][c] = acc[i][c] * a + pv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    if (t >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + t) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
             cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * Hq, (Sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int causal, float scale,
           cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 112:  // zamba2-7b: 3584 / 32 heads; lanes 16-31 own no 4th column
      return launch_d<T, 112>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q and out [B, Sq, Hq, D], k and v [B, Sk, Hkv, D], all contiguous and of
// one type (dtype 0: float32, 1: bfloat16); D in {16, 32, 64, 112, 128}, Hq a
// multiple of Hkv.  Launches on `stream` (PyTorch's current stream).
// Returns the cudaError_t of the launch; 0 means it was queued.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int causal, float scale, int dtype,
                                      int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
