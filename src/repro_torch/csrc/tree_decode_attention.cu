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
// What bounds it: at the main path's A = 8, G = 4 the 32 query vectors do
// 4 * 32 flops per K/V element pair (32 flops per byte of bf16 K/V), above
// the card's float32 rate per byte of device memory (about 20), so the
// float32 score and p.V loops in shared memory bound it, not the bytes.
// The prefix is shared by all A candidates, so it is read ONCE per (row,
// KV head) for all A * G query vectors: that single read is the point of
// the TPU kernel, and A separate decode passes would read it A times.
// Bytes bound it once those loops move to register tiles or tensor cores.
//
// Design (decode_tiles.cuh): one block per (row, KV head) holds all A * G
// query vectors and their online-softmax states in shared memory, streams
// the prefix in 32-key tiles (any S and any block size; the Pallas rule
// S % block_k == 0 is not needed), then folds the A tail entries in as one
// more tile under the mask (A <= 32).

#include "decode_tiles.cuh"

namespace {

template <class Rows>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* kv_len, const void* k_spec, const void* v_spec,
             const int32_t* mask, void* out, Rows rows, int B, int A, int Hkv,
             int G, int D, float scale, int dtype, int device, void* stream) {
  if (B <= 0 || A <= 0 || A > decode_tiles::kTile || Hkv <= 0 || G <= 0 ||
      D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return decode_tiles::launch<float, Rows, true>(
          q, k, v, kv_len, k_spec, v_spec, mask, out, rows, B, A, Hkv, G, D,
          scale, s);
    case 1:
      return decode_tiles::launch<__nv_bfloat16, Rows, true>(
          q, k, v, kv_len, k_spec, v_spec, mask, out, rows, B, A, Hkv, G, D,
          scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, A, Hkv * G, D], k_cache and v_cache [B, S, Hkv, D], k_spec and
// v_spec [B, A, Hkv, D], out [B, A, Hkv * G, D], all contiguous and of one
// type (dtype 0: float32, 1: bfloat16); kv_len int32 [B]; mask int32
// [A, A] (nonzero: attend).  Returns the cudaError_t of the launch.
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
