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
// warp steps of loads an iteration, copied by cp.async into a ring of two
// iterations in shared memory (32 KB a block, 16 KB in flight while the
// other 16 KB are used at bf16 D = 128); the per-warp states merge in the
// ring's space at the end, so several blocks share an SM.  D must be a multiple of 16
// bytes' worth of elements and at most 256.
//
// Few rows over long caches (8 rows x 8 KV heads is 64 blocks on 132 SMs,
// ~1 MB of loads in flight, a quarter of the bandwidth): S is split
// across blocks.  The wrapper's plan (ops.decode_parts, from shapes only)
// picks the parts: one wherever the unsplit grid fills the card or the
// cache is short, else parts of whole multiples of 512 keys, for about 2
// blocks an SM.  Each part runs the same body over its keys and writes
// its float32 out and log-sum-exp to a workspace; a second kernel,
// launched as a programmatic dependent, merges them as
// layers.merge_by_lse does.  A row whose keys all fall in the first part
// gives the unsplit kernel's bits.  The body reads K/V through a cp.async
// ring in shared memory (decode_split.cuh), the next iteration's chunks
// in flight while this one's are used.
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
// over S).  parts: the number of parts of S the keys are split into
// across blocks (1: one block per row, KV head and query group, the
// unsplit kernel); for parts > 1, ws is a float32 workspace of parts * B
// * Hq * (D + 1) elements, 16-byte aligned.  Launches on `stream`
// (PyTorch's current stream).  Returns the cudaError_t of the launches; 0
// means they were queued.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int32_t* kv_len,
                                       void* out, float* lse, float* ws, int B,
                                       int S, int Hkv, int G, int D, int Hq,
                                       int q_head0, int parts, float scale,
                                       int dtype, int device, void* stream) {
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
                                                Hkv, G, D, scale, win, ws, parts,
                                                s);
    case 1:
      if (lse != nullptr)
        return decode_split::launch<__nv_bfloat16, float>(
            q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, win, ws, parts, s);
      return decode_split::launch<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, win, ws, parts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
