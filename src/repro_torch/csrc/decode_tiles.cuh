// Where the port's decode-attention kernels find a row's keys, for Hopper
// (sm_90a).  The body they share (decode_split.cuh) is written over these
// `Rows` policies: DenseRows reads a [B, S, Hkv, D] cache (decode and
// tree-decode steps over a dense cache), PagedRows a [P, bs, Hkv, D] block
// pool through the row's page table (their paged twins).  Only the
// addresses differ between the dense and the paged kernels, never the
// arithmetic.  The tree kernels, which copy a row's prefix into shared
// memory once, look its page ids up once (`page`, into a list of ids())
// and address the copy's keys through that list (`staged_offset`).  The
// decode kernels read a part of a row's keys (all of them, or one part of
// S split across blocks) through part(): DensePart, or PagedPart, whose
// keys' pool rows the block stages in shared memory before its key loop,
// so no K/V load waits on a page-table load or a division.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_tiles {

constexpr float kNegInf = -1e30f;

// Keys t0 .. of row b of a dense cache [B, S, Hkv, D]: key t of the part
// is key t0 + t of the row.
struct DensePart {
  static constexpr bool kStagesIds = false;
  int S, t0;
  __device__ __forceinline__ long long offset(int b, int h, int t, int Hkv,
                                              int D) const {
    return ((static_cast<long long>(b) * S + t0 + t) * Hkv + h) *
           static_cast<long long>(D);
  }
};

// Keys t0 .. of row b of a pool [P, bs, Hkv, D]: key t of the part is key
// t0 + t of the row, t0 = p0 * bs + shift.  The pool rows (block id * bs
// + offset in the block) of its first n_stage keys are staged in shared
// memory at key_row (shared address key_row_s), so such a key's address
// costs a shared-memory read beside the dense kernel's arithmetic; keys
// past them, which only a part of more keys than the stage holds
// reaches, look their page up in the row's table (`row`, from page p0).
// Ids are clamped into [0, P - 1] as PagedRows::page clamps.  early[e]
// is the page id of this thread's e-th key (tid + e * nthreads), loaded
// when the part was made.  A key's page is t / bs by a multiply and a
// shift: umulhi(2 t, mul) >> shr with shr = ceil(log2 bs) and mul =
// ceil(2^(31 + shr) / bs) (the round-up method, exact for every t < 2^31,
// bs = 1 included).
struct PagedPart {
  static constexpr bool kStagesIds = true;
  int* key_row;
  const int32_t* row;
  uint32_t key_row_s, mul, shr;
  int n_stage, P, bs, shift;
  int early[2];
  __device__ __forceinline__ int page(int tt) const {
    return static_cast<int>(__umulhi(2u * static_cast<uint32_t>(tt), mul) >> shr);
  }
  __device__ __forceinline__ int id(int i) const { return min(max(row[i], 0), P - 1); }
  // The part's staged keys' pool rows to shared memory; the caller syncs.
  __device__ __forceinline__ void stage(int tid, int nthreads) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = tid + e * nthreads;
      if (j < n_stage) key_row[j] = early[e] * bs + j + shift - page(j + shift) * bs;
    }
#pragma unroll 4
    for (int j = tid + 2 * nthreads; j < n_stage; j += nthreads) {
      const int i = page(j + shift);
      key_row[j] = id(i) * bs + j + shift - i * bs;
    }
  }
  __device__ __forceinline__ long long offset(int, int h, int t, int Hkv,
                                              int D) const {
    int pool_row;
    if (t < n_stage) {
      asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(pool_row) : "r"(key_row_s + 4u * t));
    } else {
      const int tt = t + shift;
      const int i = page(tt);
      pool_row = id(i) * bs + tt - i * bs;
    }
    return (static_cast<long long>(pool_row) * Hkv + h) * static_cast<long long>(D);
  }
};

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
  // Ints of shared memory a part stages: none.
  __host__ __device__ __forceinline__ int part_ints(int) const { return 0; }
  __device__ __forceinline__ DensePart part(int, int t0, int, int*, int, int, int) const {
    return DensePart{S, t0};
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
  // Ints of shared memory a part of `keys` keys stages: a pool row a key,
  // at most the row's keys.
  __host__ __device__ __forceinline__ int part_ints(int keys) const {
    return keys < limit() ? keys : limit();
  }
  // The n keys from t0 of row b, up to cap of their pool rows to be staged
  // at key_row (PagedPart::stage) by nthreads threads, the page ids of
  // thread tid's first two keys loaded now.
  __device__ __forceinline__ PagedPart part(int b, int t0, int n, int* key_row,
                                            int cap, int tid, int nthreads) const {
    const int p0 = t0 / bs;
    const int shift = t0 - p0 * bs;
    const int n_stage = min(n, cap);
    const int32_t* row = table + static_cast<long long>(b) * n_pages + p0;
    const uint32_t shr = bs > 1 ? 32 - __clz(bs - 1) : 0;
    const uint32_t mul = static_cast<uint32_t>(((1ull << (31 + shr)) + bs - 1) / bs);
    PagedPart view{key_row, row, static_cast<uint32_t>(__cvta_generic_to_shared(key_row)), mul,
                   shr, n_stage, P, bs, shift, {0, 0}};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = tid + e * nthreads;
      if (j < n_stage) view.early[e] = view.id(view.page(j + shift));
    }
    return view;
  }
};

}  // namespace decode_tiles
