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
// softmax runs online in float32 (running max m, sum l, accumulator acc),
// p and p.V stay in float32, and the output is acc / max(l, 1e-20): a row
// with kv_len = 0 reads nothing and gives zeros.
//
// What bounds it: device-memory bytes.  Every valid K/V entry is read once
// and used by G query heads, so a call moves about 2 * sum_b kv_len[b] *
// Hkv * D elements and does 4 * G flops per element pair: at G = 4 that is
// 4 flops per byte of bf16 K/V, far below what the CUDA cores can do per
// byte (about 20), so no tensor cores are needed.  What is needed is wide
// loads with enough of them in flight: at the main path's shape (128 rows
// x 8 KV heads, kv_len <= 160) a block has only ~160 keys, so a design
// that loads a tile, waits, and computes pays the load latency once per
// tile.
//
// Design: decode_split.cuh over a dense cache (DenseRows).  One block per
// (row, KV head) with its G query heads together, so each K/V entry is
// read from device memory once per row, as in the Pallas kernel.  Its 4
// warps take the row's keys in interleaved groups, D * sizeof(T) / 16
// lanes per key, one 16-byte load of K and of V per lane and key, four
// warp steps of loads issued before their use (16 KB per block in flight
// at bf16 D = 128); the per-warp states merge in 8 KB of shared memory at
// the end, so several blocks share an SM.  D must be a multiple of 16
// bytes' worth of elements and at most 256.
//
// Two options serve a cache placed on a device mesh (models/layers.py,
// on_cache_shards): a head window, q holding some of the model's heads
// (a rank's under tensor parallelism), each reading its KV head from the
// whole cache in place (one block per row and KV head the window spans);
// and a log-sum-exp output beside a float32 out, by which the parts of a
// cache split over S merge (the split-KV decode cell).

#include "decode_split.cuh"

// k and v [B, S, Hkv, D]; q and out [B, Hq, D], the model's query heads
// q_head0 .. q_head0 + Hq - 1 of Hkv * G (all of them: Hq = Hkv * G,
// q_head0 = 0); all contiguous, q, k, v of one type (dtype 0: float32, 1:
// bfloat16) and 16-byte aligned; D a multiple of 16 / sizeof(type), at
// most 256; kv_len int32 [B].  lse null: out in q's type.  lse not null:
// out float32 (normalised, not rounded) and lse float32 [B, Hq], each
// head's log-sum-exp of its scaled scores (the merge of a cache split
// over S).  Launches on `stream` (PyTorch's current stream).  Returns the
// cudaError_t of the launch; 0 means it was queued.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int32_t* kv_len,
                                       void* out, float* lse, int B, int S,
                                       int Hkv, int G, int D, int Hq,
                                       int q_head0, float scale, int dtype,
                                       int device, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || Hq <= 0 ||
      q_head0 < 0 || q_head0 + Hq > Hkv * G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode_tiles::DenseRows rows{S};
  const decode_split::Window win{Hq, q_head0, lse};
  switch (dtype) {
    case 0:
      return decode_split::launch<float, float>(q, k, v, kv_len, out, rows, B,
                                                Hkv, G, D, scale, win, s);
    case 1:
      if (lse != nullptr)
        return decode_split::launch<__nv_bfloat16, float>(
            q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, win, s);
      return decode_split::launch<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, win, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
