"""Paged KV cache: a shared block pool, per-slot page tables and refcounts
(counterpart of ``repro.models.paged``).

K/V live in a pool of fixed-size blocks ``[L, P, bs, Hkv, D]``; logical
position ``t`` of slot ``n`` lives at pool row ``(table[n, t // bs], t %
bs)``.  Blocks carry refcounts, so sibling search slots that fan out from
one root prefill point at the same prefix blocks, and a slot copies a
block only when it is about to write into a shared one (copy-on-write).
Rollback is a page-table edit: the refcounts of the dropped suffix pages
fall back into the free pool.

Invariants (held by ``tests/test_torch_paged.py``, as by the reference's
``tests/test_paged_evaluator.py``):

* ``refcount[p]`` is the number of live table entries ``table[n, i] ==
  p`` with ``i < ceil(len[n] / bs)``, counted with multiplicity;
* table entries at page indices ``>= ceil(len[n] / bs)`` are garbage (the
  sentinel ``P`` or stale ids) and are never dereferenced unclipped;
* a slot writes only into blocks it owns with ``refcount == 1``.

Refcount updates add at duplicate indices (siblings share a page), so
they go through ``index_add``, which accumulates duplicates; ``t[idx] +=
x`` would not.  The table and refcount functions here are functional (they
return new tensors, as the reference's do); the model steps write the
pools in place.  Allocation failure cannot raise inside a batched step, so
it counts into an ``oom`` tensor that the evaluators raise as
:class:`PagePoolExhaustedError` at a host boundary.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import attention_block, paged_tree_attention_block, rms_norm
from .lm import CALLS, KV_CACHE_FAMILIES, _ffn, layer_params, unembed


class PagePoolExhaustedError(RuntimeError):
    """The shared KV block pool ran out of free blocks.

    Raised at host boundaries (``init_aux``, ``check_exhausted``) when the
    latched ``oom`` counter is nonzero; grow ``num_blocks`` or lower the
    number of concurrent slots.
    """


def num_pages(max_len: int, block_size: int) -> int:
    return -(-max_len // block_size)


def init_paged_cache(cfg: ModelConfig, n_slots: int, max_len: int, *, block_size: int,
                     num_blocks: int, device="cuda") -> dict:
    """An empty paged KV cache: zero pools ``[L, P, bs, Hkv, D]``, tables
    full of the sentinel ``P`` ("no block"), ``len`` 0, every block free
    and ``oom`` 0 (allocation requests that found no free block)."""
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"paged KV caches support families {KV_CACHE_FAMILIES}, "
                         f"not {cfg.family!r}")
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "table": torch.full((n_slots, num_pages(max_len, block_size)), num_blocks,
                            dtype=torch.int32, device=device),
        "len": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "refcount": torch.zeros((num_blocks,), dtype=torch.int32, device=device),
        "oom": torch.zeros((), dtype=torch.int32, device=device),
    }


def add_at(x: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """``x`` with ``values`` added at ``index`` where ``mask`` holds and
    the index is in range, duplicates accumulating: the reference's
    ``x.at[idx].add(v, mode="drop")``."""
    index = index.reshape(-1).to(torch.int64)
    keep = mask.reshape(-1) & (index >= 0) & (index < x.shape[0])
    idx = torch.clamp(index, 0, x.shape[0] - 1)
    add = torch.where(keep, values.reshape(-1).to(x.dtype), 0)
    return x.index_add(0, idx, add)


def alloc_blocks(refcount: torch.Tensor,
                 need: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One free pool block per requesting row: the ``k``-th requesting row
    (in row order) gets the ``k``-th free block (in pool order).

    ``refcount i32[P]``, ``need bool[N]``.  Returns ``(blocks i32[N],
    refcount, n_failed)``: ``blocks`` holds the block id, or the sentinel
    ``P`` for rows that asked for nothing or found the pool exhausted; the
    blocks handed out come back with refcount 1; ``n_failed`` counts needy
    rows that got nothing.  No host sync: the ``k``-th free block is found
    by a binary search of the running count of free blocks.
    """
    p = refcount.shape[0]
    free_seen = torch.cumsum((refcount == 0).to(torch.int64), dim=0)
    req_rank = torch.cumsum(need.to(torch.int64), dim=0) - 1
    block = torch.searchsorted(free_seen, torch.clamp_min(req_rank, 0) + 1)
    blocks = torch.where(need, block, p).to(torch.int32)
    got = need & (blocks < p)
    refcount = add_at(refcount, blocks, torch.ones_like(blocks), got)
    return blocks, refcount, (need & ~got).sum().to(torch.int32)


def release_pages(refcount: torch.Tensor, table: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """Decref every table entry in ``[lo[r], hi[r])`` of each row of
    ``table [R, n_pages]``: blocks whose count reaches 0 rejoin the free
    pool, shared blocks lose one sharer (duplicates accumulate)."""
    pages = torch.arange(table.shape[1], device=table.device)
    live = (pages[None, :] >= lo[:, None]) & (pages[None, :] < hi[:, None])
    return add_at(refcount, table, torch.full_like(table, -1), live)


def blocks_in_use(cache) -> torch.Tensor:
    """Number of pool blocks currently allocated (refcount > 0)."""
    return (cache["refcount"] > 0).sum()


def gather_pages(cache) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense per-slot K/V views ``[L, N, n_pages * bs, Hkv, D]`` (a copy;
    positions ``>= len[n]`` are garbage), for oracles and debugging."""
    p = cache["k"].shape[1]
    tab = torch.clamp(cache["table"].to(torch.int64), 0, p - 1)

    def gather(pool):
        out = pool[:, tab]                       # [L, N, n_pages, bs, Hkv, D]
        l_, n_, mp, bs = out.shape[:4]
        return out.reshape(l_, n_, mp * bs, *out.shape[4:])

    return gather(cache["k"]), gather(cache["v"])


def paged_decode_step(params, cfg: ModelConfig, token, cache) -> tuple[torch.Tensor, dict]:
    """One decode step over a paged cache: write and attend.

    The caller owns the page bookkeeping (copy-on-write, allocation,
    refcounts, ``len``) and passes the resolved targets in ``cache``:

    * ``write_block``/``write_off`` (``i32[N]``): where each row's new K/V
      entry lands; block ``P`` means "no write" (a masked row or an
      exhausted pool);
    * ``pos`` (``i32[N]``): the query's absolute position (RoPE);
    * ``len`` (``i32[N]``): the attend length, counting the token written.

    The new K/V are written into ``cache['k']``/``cache['v']`` **in
    place**.  Returns ``(logits [N, V], cache)``.
    """
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"paged_decode_step supports families {KV_CACHE_FAMILIES}, "
                         f"not {cfg.family!r}")
    CALLS["paged_decode_step"] += 1
    token = token.reshape(-1, 1)
    x = params["embed"][token]
    positions = cache["pos"][:, None]
    for layer in range(cfg.num_layers):
        bp = layer_params(params, layer)
        layer_cache = {"k": cache["k"][layer], "v": cache["v"][layer],
                       "table": cache["table"], "len": cache["len"],
                       "write_block": cache["write_block"],
                       "write_off": cache["write_off"]}
        h, _ = attention_block(bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps),
                               positions, cache=layer_cache)
        x, _ = _ffn(cfg, bp, x + h)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, x)[:, -1, :], cache


def paged_decode_frontier(params, cfg: ModelConfig, tokens,
                          cache) -> tuple[torch.Tensor, dict]:
    """Score ``A`` candidate next tokens per row over a paged prefix, in
    one forward; the read-only twin of :func:`repro_torch.models.lm
    .decode_frontier`.

    ``tokens [N, A]`` are alternatives for position ``cache['len']``; the
    prefix is read through ``cache['table']`` and the pools are never
    written.  Returns ``(logits [N, A, V], spec)`` with ``spec = {"k",
    "v": [L, N, A, Hkv, D]}``, each candidate's own K/V entry, for the
    caller to commit through its page bookkeeping.
    """
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"paged_decode_frontier supports families {KV_CACHE_FAMILIES}, "
                         f"not {cfg.family!r}")
    CALLS["paged_decode_frontier"] += 1
    n, a = tokens.shape
    x = params["embed"][tokens]
    cur_len = torch.as_tensor(cache["len"], device=x.device).to(torch.int32)
    positions = (cur_len[:, None] if cur_len.dim() == 1 else cur_len).expand(n, a)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        bp = layer_params(params, layer)
        h, k, v = paged_tree_attention_block(
            bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps), positions,
            cache["k"][layer], cache["v"][layer], cache["table"], cur_len)
        x, _ = _ffn(cfg, bp, x + h)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, x), {"k": torch.stack(ks), "v": torch.stack(vs)}
