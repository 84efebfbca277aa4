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

The dense and paged kernels may split S across blocks (``ops.decode_parts``
picks how many parts); ``decode_attention_split_ref`` and
``paged_decode_attention_split_ref`` model that: each part attended as the
unsplit version attends, with its log-sum-exp, the parts merged by
log-sum-exp in part order, as the kernels' merge does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# S split across blocks: a part holds a whole number of SPLIT_KEYS keys,
# which every shape's keys per body iteration (8 to 512) divide;
# `kPartKeys` in csrc/decode_split.cuh.
SPLIT_KEYS = 512


def part_keys(limit: int, parts: int) -> int:
    """Keys per part when ``limit`` keys are split into ``parts``: ``ceil(limit
    / parts)`` rounded up to a multiple of :data:`SPLIT_KEYS` (the kernels'
    formula; part ``i`` holds keys ``i * part_keys`` onwards)."""
    per = -(-limit // parts)
    return -(-per // SPLIT_KEYS) * SPLIT_KEYS


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
    return _attend(q, k_cache, v_cache, 0, kv_len, q_head0, num_heads, return_lse)


def _attend(q, k_cache, v_cache, lo: int, hi, q_head0, num_heads, return_lse):
    """:func:`decode_attention_ref` over the keys ``lo <= t < hi`` of each
    row (``hi``: an int or ``[B]``), masked in the whole cache rather than
    sliced out of it, so the first part of a row whose keys all lie there
    takes the unsplit version's arithmetic."""
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
    lens = torch.as_tensor(hi, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < lens
    if lo:
        valid = valid & (pos[None, :] >= lo)
    valid = valid[:, None, None, :]                          # [B or 1, 1, 1, S]
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


def merge_parts(outs, lses) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' merge of the parts of S, in part order: ``outs`` float32
    ``[..., D]`` (each normalised over its part), ``lses`` ``[...]``; ``m``
    the max of the ``lse`` (0 where all are ``-inf``), ``w = exp(lse -
    m)``, ``out = sum w out / max(sum w, 1e-30)``, ``lse = m + log(sum
    w)``."""
    m = torch.stack(list(lses)).amax(dim=0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    num, den = torch.zeros_like(outs[0]), torch.zeros_like(m)
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - m)
        num = num + w[..., None] * out
        den = den + w
    return num / torch.clamp_min(den, 1e-30)[..., None], m + torch.log(den)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, kv_len, parts: int, *,
                               q_head0: int = 0, num_heads: int | None = None,
                               return_lse: bool = False):
    """:func:`decode_attention_ref` with S split into ``parts`` parts of
    :func:`part_keys` keys: each part attends its keys ``offset <= t <
    min(len, offset + part_keys)`` with its log-sum-exp, then
    :func:`merge_parts`; rounded once to ``q``'s dtype, or, with
    ``return_lse``, ``(out, lse)`` in float32.  Parts past S hold no key
    and weigh 0, so a row whose keys all fall in the first part gives the
    unsplit version's bits."""
    s = k_cache.shape[1]
    keys = part_keys(s, parts)
    lens = torch.as_tensor(kv_len, device=q.device)
    outs, lses = [], []
    for lo in range(0, s, keys):
        out, lse = _attend(q, k_cache, v_cache, lo, torch.clamp(lens, lo, lo + keys), q_head0,
                           num_heads, True)
        outs.append(out)
        lses.append(lse)
    out, lse = merge_parts(outs, lses)
    return (out, lse) if return_lse else out.to(q.dtype)


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


def paged_decode_attention_split_ref(q: torch.Tensor, pool_k: torch.Tensor,
                                     pool_v: torch.Tensor, page_table: torch.Tensor,
                                     kv_len, parts: int) -> torch.Tensor:
    """:func:`paged_decode_attention_ref` with its ``n_pages * bs`` keys
    split into ``parts`` parts, as :func:`decode_attention_split_ref`
    splits a dense cache of that many keys."""
    return decode_attention_split_ref(q, _gather_pages(pool_k, page_table),
                                      _gather_pages(pool_v, page_table), kv_len, parts)


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
