// Where the port's decode-attention kernels find a row's keys, for Hopper
// (sm_90a).  The body they share (decode_split.cuh) is written over these
// `Rows` policies: DenseRows reads a [B, S, Hkv, D] cache (decode and
// tree-decode steps over a dense cache), PagedRows a [P, bs, Hkv, D] block
// pool through the row's page table (their paged twins).  Only the
// addresses differ between the dense and the paged kernels, never the
// arithmetic.  The tree kernels, which copy a row's prefix into shared
// memory once, look its page ids up once (`page`, into a list of ids())
// and address the copy's keys through that list (`staged_offset`).

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
  __host__ __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    return ((static_cast<long long>(b) * S + t) * Hkv + h) *
           static_cast<long long>(D);
  }
  // Page ids a copy of a row's first n keys needs: none.
  __host__ __device__ __forceinline__ int ids(int) const { return 0; }
  __device__ __forceinline__ int page(int, int) const { return 0; }
  __device__ __forceinline__ long long staged_offset(const int*, int b, int h,
                                                     int t, int Hkv,
                                                     int D) const {
    return offset(b, h, t, Hkv, D);
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
  __host__ __device__ __forceinline__ int limit() const { return n_pages * bs; }
  // Block id of page i of row b, clamped into [0, P - 1].
  __device__ __forceinline__ int page(int b, int i) const {
    const int blk = table[static_cast<long long>(b) * n_pages + i];
    return min(max(blk, 0), P - 1);
  }
  __device__ __forceinline__ long long at(int blk, int off, int h, int Hkv,
                                          int D) const {
    return ((static_cast<long long>(blk) * bs + off) * Hkv + h) *
           static_cast<long long>(D);
  }
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    const int page_i = t / bs;
    return at(this->page(b, page_i), t - page_i * bs, h, Hkv, D);
  }
  // The first n keys of a row span ceil(n / bs) pages; `id` holds their
  // block ids, looked up by page().
  __host__ __device__ __forceinline__ int ids(int n) const {
    return (n + bs - 1) / bs;
  }
  __device__ __forceinline__ long long staged_offset(const int* id, int, int h,
                                                     int t, int Hkv,
                                                     int D) const {
    const int page_i = t / bs;
    return at(id[page_i], t - page_i * bs, h, Hkv, D);
  }
};

}  // namespace decode_tiles
