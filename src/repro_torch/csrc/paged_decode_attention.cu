// Single-token GQA decode attention over a paged KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_attention_fwd`
// (src/repro/kernels/decode_attention/decode_attention.py, body
// `_paged_decode_kernel`): each of B rows attends its first kv_len[b] keys,
// whose K/V live in a shared block pool [P, bs, Hkv, D]; logical key t of
// row b sits at (page_table[b, t / bs], t % bs).  The math is the dense
// decode kernel's (online softmax in float32, p and p.V in float32, output
// acc / max(l, 1e-20), so kv_len = 0 gives zeros); only the addressing
// differs.  No dense copy of the cache is gathered: the block reads the
// pool through the table itself.
//
// What bounds it: device-memory bytes, as the dense kernel: every valid K/V
// entry is read once per (row, KV head) and used by the G query heads (4 * G
// flops per bf16 K/V pair: 4 flops per byte at G = 4, below the card's
// float32 rate per byte).
//
// Design: the dense kernel's key-split body (decode_split.cuh) over the
// pool (decode_tiles.cuh's PagedRows): one block per (row, KV head), its G
// query heads together; the warps take the row's keys in interleaved
// groups, read as 16-byte chunks, one per lane.  Before its key loop the
// block stages the row's live page ids in shared memory (up to what fits
// beside the merge buffer; pages past them are looked up in the table),
// so a key's address costs a shared-memory read, and no K/V load of a
// step waits on a page-table load from device memory.  Where the grid is
// too small for the card, S is split across blocks and the parts merged
// by log-sum-exp, exactly as in the dense kernel, with the same parts for
// the same key limit.  The arithmetic, and so every rounding, is the
// dense kernel's: a paged search makes the dense search's decisions.  Only
// pages below ceil(kv_len / bs) are looked up, and each id is clamped
// into [0, P - 1], so the sentinel P and stale ids past the live pages
// are never dereferenced.  Any block size bs >= 1 takes the same path (the
// main path uses 16); D is a multiple of 16 bytes' worth of elements, at
// most 256.

#include "decode_split.cuh"

// q [B, Hkv * G, D], pool_k and pool_v [P, bs, Hkv, D], table int32
// [B, n_pages], kv_len int32 [B], out [B, Hkv * G, D]; all contiguous, q,
// pools and out of one type (dtype 0: float32, 1: bfloat16) and 16-byte
// aligned.  parts: the number of parts of S (n_pages * bs keys) split
// across blocks, as in decode_attention_launch (1: the unsplit kernel);
// for parts > 1, ws is a float32 workspace of parts * B * Hkv * G * (D +
// 1) elements, 16-byte aligned.  Launches on `stream` (PyTorch's current
// stream).  Returns the cudaError_t of the launches; 0 means they were
// queued.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const int32_t* table, const int32_t* kv_len, void* out, float* ws, int B,
    int P, int bs, int n_pages, int Hkv, int G, int D, int parts, float scale,
    int dtype, int device, void* stream) {
  if (B <= 0 || P <= 0 || bs <= 0 || n_pages <= 0 || Hkv <= 0 || G <= 0 ||
      D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode_tiles::PagedRows rows{table, n_pages, P, bs};
  switch (dtype) {
    case 0:
      return decode_split::launch<float>(q, pool_k, pool_v, kv_len, out, rows,
                                         B, Hkv, G, D, scale, ws, parts, s);
    case 1:
      return decode_split::launch<__nv_bfloat16>(q, pool_k, pool_v, kv_len,
                                                 out, rows, B, Hkv, G, D,
                                                 scale, ws, parts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
