"""Plain PyTorch versions of the decode-attention kernels.

The same functions as the CUDA kernels (``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu``, ``csrc/tree_decode_attention.cu``) and
as the Pallas kernels they replace (``repro/kernels/decode_attention``):
query tokens attend the row's first ``kv_len`` cache entries (dense, or
paged through a page table; the tree versions add each candidate's
speculative tail under a tree mask), with scores, ``p`` and ``p·V`` in
float32 and the output ``acc / max(l, 1e-20)``, so a query with nothing to
attend gives zeros.  (The XLA oracles in ``models/layers.py`` round ``p``
to the cache's type first, and give such a query the mean of V.)

The wrappers in :mod:`.ops` call these for CPU tensors; they run on any
device, which is how ``chip_smoke.py`` compares the kernels with them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len, *, q_head0: int = 0,
                         num_heads: int | None = None, return_lse: bool = False):
    """``q [B, Hq, D]``, caches ``[B, S, Hkv, D]``, ``kv_len`` int ``[]``
    or ``[B]`` -> ``[B, Hq, D]`` in ``q``'s dtype.

    A head window: ``q`` holds heads ``q_head0 .. q_head0 + Hq - 1`` of a
    model of ``num_heads`` query heads (default ``Hq``: all of them), head
    ``j`` reading KV head ``j // (num_heads / Hkv)`` of the whole cache.
    With ``return_lse`` the result is ``(out, lse)``: ``out`` float32 (not
    rounded to ``q``'s dtype) and ``lse [B, Hq]`` float32, each head's
    log-sum-exp of its scaled scores over the valid keys (``-inf`` for a
    row with none, whose ``out`` is 0)."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = (hq if num_heads is None else num_heads) // hkv
    scale = 1.0 / math.sqrt(d)
    # The KV heads the window spans, and q padded to their whole groups.
    h_lo, h_hi = q_head0 // group, (q_head0 + hq - 1) // group + 1
    pad_lo, pad_hi = q_head0 - h_lo * group, h_hi * group - q_head0 - hq
    qf = F.pad(q.float(), (0, 0, pad_lo, pad_hi)).reshape(b, h_hi - h_lo, group, d)
    kc, vc = k_cache[:, :, h_lo:h_hi], v_cache[:, :, h_lo:h_hi]
    scores = torch.einsum("bhgd,bshd->bhgs", qf, kc.float()) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = (pos[None, :] < lens)[:, None, None, :]          # [B or 1, 1, 1, S]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vc.float())
    out = out / torch.clamp_min(l, 1e-20)[..., None]
    out = out.reshape(b, -1, d)[:, pad_lo:pad_lo + hq]
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -torch.inf)
    return out, lse.reshape(b, -1)[:, pad_lo:pad_lo + hq]


def _gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Dense view ``[B, n_pages * bs, Hkv, D]`` of each row's pages; table
    entries are clipped into ``[0, P - 1]`` (entries past a row's live
    pages are masked by ``kv_len`` afterwards)."""
    p, bs, hkv, d = pool.shape
    b, n_pages = page_table.shape
    tab = torch.clamp(page_table.to(torch.int64), 0, p - 1)
    return pool[tab].reshape(b, n_pages * bs, hkv, d)


def paged_decode_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor, page_table: torch.Tensor,
                               kv_len) -> torch.Tensor:
    """``q [B, Hq, D]`` over the first ``kv_len`` keys of each row, whose
    K/V live in pools ``[P, bs, Hkv, D]`` at ``(page_table[b, t // bs],
    t % bs)``; ``page_table`` is ``i32[B, n_pages]``.  Returns ``[B, Hq,
    D]`` in ``q``'s dtype; a ``kv_len = 0`` row gives zeros.  (The plain
    version gathers the pages; the kernel reads the pool in place.)"""
    return decode_attention_ref(q, _gather_pages(pool_k, page_table),
                                _gather_pages(pool_v, page_table), kv_len)


def tree_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_spec: torch.Tensor,
                              v_spec: torch.Tensor, kv_len,
                              tree_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``A`` candidate queries per row, ``q [B, A, Hq, D]``, attend the
    row's first ``kv_len`` cache entries (``[B, S, Hkv, D]``) plus the
    speculative tail ``k_spec``/``v_spec [B, A, Hkv, D]``: candidate ``a``
    sees tail entry ``j`` where ``tree_mask[a, j]`` (``[A, A]``, default
    the identity).  Scores, ``p`` and ``p·V`` in float32; a query with
    nothing to attend gives zeros.  Returns ``[B, A, Hq, D]``."""
    b, a, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, a, hkv, group, d)
    scores = torch.einsum("bahgd,bshd->bahgs", qf, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = (pos[None, :] < lens)[:, None, None, None, :]          # [B?,1,1,1,S]
    tail = torch.einsum("bahgd,bjhd->bahgj", qf, k_spec.float()) * scale
    if tree_mask is None:
        tree_mask = torch.eye(a, dtype=torch.bool, device=q.device)
    attend = tree_mask.to(device=q.device, dtype=torch.bool)[None, :, None, None, :]
    full = torch.cat([torch.where(valid, scores, NEG_INF),
                      torch.where(attend, tail, NEG_INF)], dim=-1)
    ok = torch.cat([valid.expand(scores.shape), attend.expand(tail.shape)], dim=-1)
    m = full.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(full - m), 0.0)
    l = p.sum(dim=-1)
    out = (torch.einsum("bahgs,bshd->bahgd", p[..., :s], v_cache.float())
           + torch.einsum("bahgj,bjhd->bahgd", p[..., s:], v_spec.float()))
    out = out / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, a, hq, d).to(q.dtype)


def paged_tree_decode_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                                    pool_v: torch.Tensor, page_table: torch.Tensor,
                                    k_spec: torch.Tensor, v_spec: torch.Tensor, kv_len,
                                    tree_mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`tree_decode_attention_ref` with the prefix in pools ``[P, bs,
    Hkv, D]`` addressed through ``page_table i32[B, n_pages]``, as
    :func:`paged_decode_attention_ref`."""
    return tree_decode_attention_ref(q, _gather_pages(pool_k, page_table),
                                     _gather_pages(pool_v, page_table), k_spec, v_spec,
                                     kv_len, tree_mask)
