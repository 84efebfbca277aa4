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
// What bounds it: the prefix, read from device memory once per (row, KV
// head) for all A candidates (the point of the TPU kernel: A separate
// decode passes would read it A times), 4 * A * G flops per prefix K/V
// element pair.
//
// Design: the decode kernels' key-split body (decode_split.cuh) with a
// tail, over a dense cache (DenseRows) or a pool (PagedRows): one block
// per (row, KV head, candidate), the A candidate blocks of a (row, KV
// head) adjacent so the prefix comes once from device memory and A - 1
// times from L2.  Candidate a's logical keys are the row's kv_len prefix
// keys, then the tail entries j it sees in order of j (A <= 32), so with
// the frontier's identity mask it computes exactly what decode_attention
// computes over the cache with entry a appended, rounding for rounding:
// a frontier forward and the decode steps of the same candidates agree.
// Warps split the keys, 16-byte loads; D is a multiple of 16 bytes' worth
// of elements, at most 256.

#include "decode_split.cuh"

namespace {

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
      return decode_split::launch<float, Rows, true>(
          q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, s, tail);
    }
    case 1: {
      const decode_split::Tail<__nv_bfloat16> tail{
          static_cast<const __nv_bfloat16*>(k_spec),
          static_cast<const __nv_bfloat16*>(v_spec), mask, A};
      return decode_split::launch<__nv_bfloat16, Rows, true>(
          q, k, v, kv_len, out, rows, B, Hkv, G, D, scale, s, tail);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, A, Hkv * G, D], k_cache and v_cache [B, S, Hkv, D], k_spec and
// v_spec [B, A, Hkv, D], out [B, A, Hkv * G, D], all contiguous, of one
// type (dtype 0: float32, 1: bfloat16) and 16-byte aligned; kv_len int32
// [B]; mask int32 [A, A] (nonzero: attend).  Returns the cudaError_t of
// the launch.
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
