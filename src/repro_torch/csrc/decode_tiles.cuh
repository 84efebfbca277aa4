// Where the port's decode-attention kernels find a row's keys, for Hopper
// (sm_90a).  The body they share (decode_split.cuh) is written over these
// `Rows` policies: DenseRows reads a [B, S, Hkv, D] cache (decode and
// tree-decode steps over a dense cache), PagedRows a [P, bs, Hkv, D] block
// pool through the row's page table (their paged twins).  Only the
// addresses differ between the dense and the paged kernels, never the
// arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_tiles {

constexpr float kNegInf = -1e30f;

// Element offset of logical key t of row b, KV head h, in a dense cache
// [B, S, Hkv, D].
struct DenseRows {
  int S;
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    return ((static_cast<long long>(b) * S + t) * Hkv + h) *
           static_cast<long long>(D);
  }
};

// Element offset of logical key t of row b, KV head h, in a pool
// [P, bs, Hkv, D] addressed through table [B, n_pages]: key t lives at
// (table[b, t / bs], t % bs).  Only the row's live pages (t < kv_len, so
// t / bs < ceil(kv_len / bs)) are ever looked up, and each id is clamped
// into [0, P - 1], so a sentinel or stale entry past the live pages is
// never dereferenced.
struct PagedRows {
  const int32_t* table;
  int n_pages, P, bs;
  __device__ __forceinline__ int limit() const { return n_pages * bs; }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    const int page = t / bs;
    const int off = t - page * bs;
    int blk = table[static_cast<long long>(b) * n_pages + page];
    blk = min(max(blk, 0), P - 1);
    return ((static_cast<long long>(blk) * bs + off) * Hkv + h) *
           static_cast<long long>(D);
  }
};

}  // namespace decode_tiles
