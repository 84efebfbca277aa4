"""Transformer building blocks (counterpart of ``repro.models.layers``):
RMSNorm, RoPE, GQA attention, enc-dec cross attention, SwiGLU and the
routed-expert MoE layer.

Everything is a function over a parameter dict, in the reference's
layouts: activations ``[B, S, d]``, attention ``[B, S, H, D]``, cache
slices ``[B, S, Hkv, D]``.  Two attention paths reach the port's kernels:

* the cache-free causal path (``forward``) runs ``flash_attention``;
* single-token decode against a cache runs ``decode_attention``, against a
  paged cache (a block pool and a page table) ``paged_decode_attention``;
* frontier scoring (:func:`tree_attention_block`,
  :func:`paged_tree_attention_block`: ``A`` candidate tokens per row over a
  read-only prefix) runs ``tree_decode_attention`` /
  ``paged_tree_decode_attention``.

On a CUDA tensor each launches its hand-written kernel, on a CPU tensor its
plain version (``kernels/*/ref.py``); both keep ``p`` and ``p·V`` in
float32, as the Pallas kernels do.  Chunked prefill and catch-up with a
cache (``S > 1``), the enc-dec encoder's non-causal self-attention and
cross attention take :func:`chunked_attention`, the reference's plain
online-softmax path, as the reference does.  The MoE layer
(:func:`moe_block`) is plain tensor ops, as in the reference, where no
Pallas kernel runs.

Under a ``DeviceMesh`` (``repro_torch.distributed.sharding.use_mesh``)
with parameters placed as DTensors, DTensor propagates the placements
through these functions; attention (the flash kernel, which reads raw
pointers, and the plain chunked path) runs on each rank's heads and rows
through ``local_map`` (:func:`on_head_shards`), single-token decode on
each rank's rows, heads and slice of S of a placed cache, the slices
merged by their log-sum-exps (:func:`on_cache_shards`), a placed cache is
written on each rank's rows and slice of S, and the MoE layer runs its
experts where they live (:func:`_moe_block_sharded`).

**In place:** :func:`attention_block` writes the new K/V into the cache
tensors (or pools) it is given and returns them; a caller that needs the
old cache keeps a copy.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.decode_attention.ops import decode_attention as decode_attention_kernel
from ..kernels.decode_attention.ops import (
    paged_decode_attention as paged_decode_attention_kernel,
)
from ..kernels.decode_attention.ops import (
    paged_tree_decode_attention as paged_tree_decode_attention_kernel,
)
from ..kernels.decode_attention.ops import (
    tree_decode_attention as tree_decode_attention_kernel,
)
from ..kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S])."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                  # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs       # [B, S, D/2]
    cos = torch.cos(angles)[..., None, :]                         # [B, S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows ``embed[tokens]`` (``F.embedding``).

    On DTensors, where the rules split the vocabulary over a mesh dim that
    does not split the tokens (``tp``'s ``model``), each rank looks up the
    tokens in its own block of rows and zeroes the others, and the partial
    sums add up over that dim (Megatron's vocab-parallel embedding); where
    the tokens are split too (``fsdp``), the table is gathered first.  The
    lookup runs on each rank's blocks through ``local_map``: DTensor's own
    rules fail here (``F.embedding`` from a split table on torch 2.13, the
    index backward's ``index_put`` on 2.11).
    """
    if not is_placed(embed):
        return F.embedding(tokens, embed)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embed.device_mesh
    if not is_placed(tokens):     # whole on every rank
        from ..distributed.sharding import distribute_leaf

        tokens = distribute_leaf(tokens, (Replicate(),) * mesh.ndim, mesh)
    tok_pl = tokens.placements
    split = [p == Shard(0) and not isinstance(t, Shard)
             for p, t in zip(embed.placements, tok_pl)]
    w_pl = tuple(Shard(0) if s else Replicate() for s in split)
    w_grad = tuple(Shard(0) if s else Partial() if isinstance(t, Shard) else Replicate()
                   for s, t in zip(split, tok_pl))
    out_pl = tuple(t if isinstance(t, Shard) else Partial() if s else Replicate()
                   for s, t in zip(split, tok_pl))

    def lookup(tok, w):
        (w,) = local_inputs(w)
        if not any(split):
            return F.embedding(tok, w)
        block = 0
        for i, s in enumerate(split):
            if s:
                block = block * mesh.size(i) + mesh.get_local_rank(i)
        lo = block * w.shape[0]
        mine = (tok >= lo) & (tok < lo + w.shape[0])
        out = F.embedding(torch.where(mine, tok - lo, 0), w)
        return out * mine[..., None].to(out.dtype)

    return local_map(lookup, out_placements=[*out_pl], in_placements=(tok_pl, w_pl),
                     in_grad_placements=(tok_pl, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, embed)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,            # [B, Sq, Hq, D]
    k: torch.Tensor,            # [B, Sk, Hkv, D]
    v: torch.Tensor,            # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    q_offset=0,                 # int, [] or [B]: absolute position of q[:, 0]
    kv_len=None,                # None, int, [] or [B]: valid KV prefix length
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (GQA-aware), the reference's
    plain path: scores in float32, ``p`` rounded to V's dtype before
    ``p·V`` (float32 accumulation).

    ``q_offset`` and ``kv_len`` may be scalars or per-row ``[B]`` vectors
    (ragged chunked catch-up: every row decodes its chunk at its own
    offset against its own valid prefix).
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    chunk = min(chunk, sk)
    if sk % chunk != 0:
        pad = chunk - sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = (torch.clamp_max(torch.as_tensor(kv_len, device=dev), sk)
                  if kv_len is not None else torch.tensor(sk, device=dev))
        sk = sk + pad
    n_chunks = sk // chunk

    qf = q.float().reshape(b, sq, hkv, group, d)
    # [Bq, Sq] with Bq in {1, B}: scalar offsets broadcast, vector offsets
    # give each row its own causal frontier.
    q_pos = (torch.as_tensor(q_offset, device=dev).to(torch.int64).reshape(-1, 1)
             + torch.arange(sq, device=dev))
    kl = None if kv_len is None else torch.as_tensor(kv_len, device=dev).reshape(-1)

    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        k_i = k[:, idx * chunk:(idx + 1) * chunk]
        v_i = v[:, idx * chunk:(idx + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_i.float()) * scale
        kv_pos = idx * chunk + torch.arange(chunk, device=dev)          # [C]
        mask = torch.ones((q_pos.shape[0], sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, :, None] >= kv_pos[None, None, :])
        if kl is not None:
            mask = mask & (kv_pos[None, None, :] < kl[:, None, None])
        mask = mask[:, None, None]                                      # [B?,1,1,Sq,C]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v_i.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    out = out.reshape(b, hq, sq, d).transpose(1, 2)                     # [B,Sq,Hq,D]
    return out.to(q.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes out contiguous: DTensor's view rules
    read the global strides, so a local gradient in another layout (the
    plain attention's, a kernel's) would fail a ``view`` upstream."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def is_placed(x) -> bool:
    # The distributed package imports the models, so its import waits for a call.
    from ..distributed.sharding import is_placed as placed

    return placed(x)


def rows_here(x, placements, mesh):
    """``x`` (offsets or lengths: a scalar or one per row, placed or whole)
    as a plain tensor for this rank's rows of a tensor placed as
    ``placements``: a scalar whole, a ``[B]`` vector split as the rows."""
    from torch.distributed.tensor import Replicate, Shard

    from ..distributed.sharding import distribute_leaf

    if not isinstance(x, torch.Tensor):
        return x
    x = x.full_tensor() if is_placed(x) else x
    if x.dim() != 1:
        return x
    rows = tuple(p if p == Shard(0) else Replicate() for p in placements)
    return distribute_leaf(x, rows, mesh).to_local()


def local_inputs(*xs):
    """The local tensors of a ``local_map`` body, their gradients made
    contiguous (:class:`_ContiguousGrad`)."""
    return tuple(_ContiguousGrad.apply(x) if x.requires_grad else x for x in xs)


def on_head_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for a kernel over ``[B, S, H, D]`` heads.

    On plain tensors this is the call itself.  On DTensors it runs on each
    rank's shards through ``local_map``: rows split as q's rows are (over
    the data axes), heads as q's heads are (over ``model`` where the rules
    shard ``wq``), the rest whole.  Where the KV heads do not split as the
    q heads do (``num_kv_heads`` not divisible by the model axis while
    ``num_heads`` is), each q head gets its own copy of its KV head first,
    so every rank holds the KV heads its q heads read.
    """
    if not is_placed(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    kw = {name: rows_here(x, pl, mesh) for name, x in kw.items()}   # offsets, lengths
    head_parts = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(2))
    if k.shape[2] % head_parts:
        group = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    call = local_map(lambda *a: fn(*local_inputs(*a), **kw).contiguous(),
                     out_placements=list(pl),
                     in_placements=(pl, pl, pl), in_grad_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)
    return call(q, k, v)


def _block_index(mesh, dims) -> int:
    """This rank's block of a tensor dim split over the mesh dims ``dims``
    (in mesh order, the first major), as DTensor splits it."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _merge(out, lse, amax, total):
    """The merge of attention parts by their log-sum-exps, ``amax`` and
    ``total`` reducing over the parts: each part weighted by ``exp(lse -
    max lse)``, numerators and weights reduced together."""
    m = amax(lse)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)
    packed = total(torch.cat([w[..., None] * out, w[..., None]], dim=-1))
    den = packed[..., -1]
    return packed[..., :-1] / torch.clamp_min(den, 1e-30)[..., None], m + torch.log(den)


def merge_by_lse(outs: torch.Tensor, lses: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over a cache split into ``n`` parts along S, from each
    part's result: ``outs [n, ..., D]`` float32, each normalised over its
    part, and ``lses [n, ...]`` their log-sum-exps (``-inf`` for a part
    with no valid key).  Returns ``(out [..., D], lse [...])`` in float32:
    the parts weighted by ``exp(lse - max lse)``; where no part has a key,
    ``out`` is 0 and ``lse`` is ``-inf``.  One part comes back as it is,
    bit for bit."""
    return _merge(outs, lses, lambda x: x.amax(dim=0), lambda x: x.sum(dim=0))


def _merge_on_mesh(out: torch.Tensor, lse: torch.Tensor, mesh, dims) -> torch.Tensor:
    """:func:`merge_by_lse` of this rank's part ``(out [B, H, D], lse [B,
    H])`` with those of the ranks that hold the other parts of S, along
    the mesh dims ``dims``: the max of ``lse`` and the weighted sums are
    all-reduced, one mesh dim after another.  Only ``[B, H]`` and ``[B, H,
    D + 1]`` float32 cross the wire, never the cache."""
    import torch.distributed as dist

    groups = [mesh.get_group(i) for i in dims]

    def reduce(op):
        def over_groups(x):
            x = x.clone()
            for g in groups:
                dist.all_reduce(x, op=op, group=g)
            return x
        return over_groups

    return _merge(out, lse, reduce(dist.ReduceOp.MAX), reduce(dist.ReduceOp.SUM))[0]


def on_cache_shards(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, kv_len,
                    num_heads: int) -> torch.Tensor:
    """One-token attention of ``q [B, Hq, D]`` over the caches ``[B, S,
    Hkv, D]`` through the ``decode_attention`` kernel.

    On plain tensors this is the kernel's call.  On a placed cache (a
    DTensor; a plain ``q`` counts as whole on every rank) the kernel runs
    on each rank's blocks through ``local_map``, the cache never moving:

    * rows: ``q``'s go where the cache's rows are (split over the data axes
      in the ``batch`` modes, whole in the sequence modes);
    * heads: ``q``'s stay split as they are (over ``model`` where the rules
      split ``wq``), except over mesh dims that split S; each rank's heads
      read their KV heads from its whole rows in place (the kernel's head
      window, ``q_head0``), also where a rank's heads are part of a group;
    * S: where mesh dims split it (``seq_data``, ``batch+seq_model``,
      ``seq_all``), each rank attends its slice with its local length
      ``clamp(len - offset, 0, S_local)`` and returns its log-sum-exp, and
      the parts merge over those dims (:func:`_merge_on_mesh`, float32,
      rounded once to ``q``'s dtype).

    Returns ``[B, Hq, D]``, placed as ``q``'s rows and heads went.
    """
    if not is_placed(k_cache):
        return decode_attention_kernel(q.contiguous(), k_cache, v_cache, kv_len)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import distribute_leaf

    mesh, cpl = k_cache.device_mesh, tuple(k_cache.placements)
    if not is_placed(q):
        q = distribute_leaf(q, (Replicate(),) * mesh.ndim, mesh)
    s_dims = [i for i, p in enumerate(cpl) if p == Shard(1)]
    qpl = tuple(Shard(0) if p == Shard(0) else
                Shard(1) if qp == Shard(1) and i not in s_dims else Replicate()
                for i, (p, qp) in enumerate(zip(cpl, q.placements)))
    head_dims = [i for i, p in enumerate(qpl) if p == Shard(1)]
    hq_local = q.shape[1] // math.prod(mesh.size(i) for i in head_dims)
    q_head0 = _block_index(mesh, head_dims) * hq_local
    s_local = k_cache.shape[1] // math.prod(mesh.size(i) for i in s_dims)
    offset = _block_index(mesh, s_dims) * s_local
    lens = torch.as_tensor(rows_here(kv_len, cpl, mesh))

    def attend(ql, kl, vl):
        ql = ql.contiguous()
        if not s_dims:
            return decode_attention_kernel(ql, kl, vl, lens, q_head0=q_head0,
                                           num_heads=num_heads)
        out, lse = decode_attention_kernel(ql, kl, vl, torch.clamp(lens - offset, 0, s_local),
                                           q_head0=q_head0, num_heads=num_heads,
                                           return_lse=True)
        return _merge_on_mesh(out, lse, mesh, s_dims).to(ql.dtype)

    return local_map(attend, out_placements=list(qpl), in_placements=(qpl, cpl, cpl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache)


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    kv_len,                 # [] or [B] — number of valid cache entries
) -> torch.Tensor:
    """Single-token attention over a KV cache: the reference's XLA oracle
    (full softmax; ``p`` rounded to the cache's dtype before ``p·V``).  The
    port's attention path runs the ``decode_attention`` kernel instead;
    this stays for tests."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, group, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention module (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    """``N(0, std²)`` drawn in float32 from ``gen`` on its device, then cast
    (the reference draws float32 normals, scales, then casts).  A source on
    the ``meta`` device (``lm.abstract_params``) gives shape and dtype only."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def init_attention(gen: torch.Generator, cfg, d_model=None, dtype=None) -> dict:
    d = d_model or cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dtype = dtype or cfg.dtype
    std = 0.02
    p = {
        "wq": normal(gen, (d, hq * hd), std, dtype),
        "wk": normal(gen, (d, hkv * hd), std, dtype),
        "wv": normal(gen, (d, hkv * hd), std, dtype),
        "wo": normal(gen, (hq * hd, d), std, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def attention_qkv(p, cfg, x, positions, rope: bool = True):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_cache(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, start: torch.Tensor) -> None:
    """Write the new K/V ``[B, s, Hkv, D]`` into the caches ``[B, S, Hkv,
    D]`` at ``start``, **in place**, as the reference's functional writes
    do:

    * scalar ``start``: one slice from ``clamp(start, 0, S - s)`` (what
      ``dynamic_update_slice`` does);
    * per-row ``start``, one token: row ``b`` writes at ``start[b]``, and
      not at all when ``start[b] >= S`` (the reference scatter drops it);
    * per-row ``start``, ``s > 1`` (ragged catch-up): row ``b`` writes
      positions ``start[b] + j``; those ``>= S`` are dropped, as the
      reference's ``mode="drop"`` scatter drops them.  ``index_put_``
      would raise on them, so they are sent to position ``start[b] - 1``,
      which no valid write of the row touches, with its own old value.

    A placed cache (DTensors) is written on each rank's rows: the new K/V
    are brought to the cache's placement and the write runs on the local
    blocks, which are the cache's storage.  Where mesh dims split S, the
    new K/V come whole over them, the positions are the global ones
    (clamped as above, or dropped past the global S), and each rank writes
    only those its slice holds (:func:`_write_slice`).
    """
    if is_placed(kc):
        from torch.distributed.tensor import Replicate, Shard

        mesh, pl = kc.device_mesh, tuple(kc.placements)
        s_dims = [i for i, p in enumerate(pl) if p == Shard(1)]
        whole_s = tuple(Replicate() if p == Shard(1) else p for p in pl)
        k, v = (x.redistribute(mesh, whole_s).to_local() for x in (k, v))
        start = rows_here(start, pl, mesh)
        if not s_dims:
            return _write_cache(kc.to_local(), vc.to_local(), k, v, start)
        s_local = kc.shape[1] // math.prod(mesh.size(i) for i in s_dims)
        return _write_slice(kc.to_local(), vc.to_local(), k, v, start,
                            _block_index(mesh, s_dims) * s_local, kc.shape[1])
    big_s, s = kc.shape[1], k.shape[1]
    if s > big_s:
        raise ValueError(f"cannot write {s} positions into a cache of length {big_s}")
    k, v = k.to(kc.dtype), v.to(vc.dtype)
    if start.dim() == 0:
        pos = torch.clamp(start, 0, big_s - s) + torch.arange(s, device=kc.device)
        kc.index_copy_(1, pos, k)
        vc.index_copy_(1, pos, v)
        return
    rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
    pos = start[:, None] + torch.arange(s, device=kc.device)[None, :]   # [B, s]
    valid = pos < big_s
    spare = torch.clamp(start - 1, 0, big_s - 1)[:, None]
    dst = torch.where(valid, pos, spare)
    keep = valid[:, :, None, None]
    kc[rows, dst] = torch.where(keep, k, kc[rows, dst])
    vc[rows, dst] = torch.where(keep, v, vc[rows, dst])


def _write_slice(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 start: torch.Tensor, offset: int, big_s: int) -> None:
    """:func:`_write_cache` into positions ``offset .. offset + S_local - 1``
    of a cache of ``big_s`` positions, whose slice ``kc``/``vc [B, S_local,
    Hkv, D]`` this rank holds: each new position is the global one (a
    scalar ``start`` clamped into ``[0, big_s - s]``, a per-row one dropped
    at ``>= big_s``), written here only if the slice holds it, **in
    place** (:func:`put_where_`)."""
    b, s_local = kc.shape[:2]
    s = k.shape[1]
    steps = torch.arange(s, device=kc.device)
    if start.dim() == 0:
        pos = (torch.clamp(start, 0, big_s - s) + steps).expand(b, s)
        keep = torch.ones((b, s), dtype=torch.bool, device=kc.device)
    else:
        pos = start[:, None] + steps[None, :]
        keep = pos < big_s
    here = pos - offset
    keep = keep & (here >= 0) & (here < s_local)
    rows = torch.arange(b, device=kc.device)[:, None].expand(b, s)
    index = (rows.reshape(-1), here.reshape(-1))
    for dst, x in ((kc, k), (vc, v)):
        put_where_(dst, index, x.reshape(b * s, *x.shape[2:]).to(dst.dtype), keep.reshape(-1))


def put_where_(dst: torch.Tensor, index: tuple, values: torch.Tensor,
               mask: torch.Tensor, lead: int = 0) -> None:
    """``dst[(:,) * lead + index] = values`` for the rows where ``mask``
    holds, **in place**; the other rows write nothing.

    The port's form of the reference's drop-mode scatter
    (``.at[idx].set(values, mode="drop")`` with an out-of-range index for
    "no write"), which ``index_put_`` cannot express: it raises on such an
    index.  ``index`` is a tuple of ``[N]`` index tensors (out-of-range
    entries allowed where ``mask`` is false), ``values`` leads with
    ``(*dst.shape[:lead], N)``; the rows that write must target distinct
    positions.  A row that does not write repeats the write of the first
    row that does (same position, same value), or, when no row writes,
    writes back the current value of one in-range position: duplicates then
    carry equal values, so the result is exact and deterministic, with no
    host sync.
    """
    n = mask.shape[0]
    if n == 0:
        return
    first = torch.argmax(mask.to(torch.int32))          # first writing row, or 0
    src = torch.where(mask, torch.arange(n, device=mask.device), first)
    dims = dst.shape[lead:lead + len(index)]
    idx = tuple(torch.clamp(i.to(torch.int64)[src], 0, size - 1)
                for i, size in zip(index, dims))
    full = (slice(None),) * lead + idx
    vals = values[(slice(None),) * lead + (src,)]
    keep = mask[src].reshape((1,) * lead + (n,) + (1,) * (vals.dim() - lead - 1))
    dst[full] = torch.where(keep, vals, dst[full])


def attention_block(
    p,
    cfg,
    x,                       # [B, S, d]
    positions,               # [B, S]
    *,
    causal: bool = True,
    rope: bool = True,
    cache=None,              # optional dict(k, v, len) — decode/prefill cache
):
    """Full attention block; returns ``(out, new_cache)``.

    Without a cache the causal path runs ``flash_attention``.  With a cache
    the new K/V are written at ``cache['len']`` (scalar or per-row ``[B]``)
    into ``cache['k']``/``cache['v']`` in place; a single token then
    attends through ``decode_attention``, a chunk through
    :func:`chunked_attention`.

    A paged cache (``"table"`` in ``cache``; single-token decode only)
    holds pools ``k``/``v [P, bs, Hkv, D]``, the page ``table [B,
    n_pages]``, the attend length ``len`` (it already counts the token
    being written, where one is) and the physical write target
    ``write_block``/``write_off`` per row, block ``P`` meaning "no write".
    The reference drops those writes with a drop-mode scatter; here they
    are a masked in-place write (:func:`put_where_`).  Attention reads the
    pools through the table (``paged_decode_attention``).
    """
    q, k, v = attention_qkv(p, cfg, x, positions, rope=rope)
    b, s = x.shape[:2]
    if cache is not None and "table" in cache:
        if s != 1:
            raise ValueError("a paged cache supports single-token decode only")
        kc, vc = cache["k"], cache["v"]
        wb, wo = cache["write_block"], cache["write_off"]
        writes = wb < kc.shape[0]
        put_where_(kc, (wb, wo), k[:, 0].to(kc.dtype), writes)
        put_where_(vc, (wb, wo), v[:, 0].to(vc.dtype), writes)
        out = paged_decode_attention_kernel(q[:, 0].contiguous(), kc, vc, cache["table"],
                                            cache["len"])[:, None]
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
        return out, dict(cache, k=kc, v=vc)
    if cache is None:
        if causal and q.shape[1] == k.shape[1]:
            out = on_head_shards(flash_attention, q, k, v, causal=True)
        else:
            out = on_head_shards(chunked_attention, q, k, v, causal=causal,
                                 chunk=cfg.attn_chunk)
        new_cache = None
    else:
        kc, vc = cache["k"], cache["v"]
        start = torch.as_tensor(cache["len"], device=x.device)
        _write_cache(kc, vc, k, v, start)
        new_len = torch.clamp_max(start + s, kc.shape[1])
        if s == 1:
            # The decode kernel takes scalar or per-row [B] cache lengths.
            out = on_cache_shards(q[:, 0], kc, vc, new_len, cfg.num_heads)[:, None]
        else:
            out = on_head_shards(chunked_attention, q, kc, vc, causal=causal, q_offset=start,
                                 kv_len=new_len, chunk=cfg.attn_chunk)
        new_cache = {"k": kc, "v": vc, "len": new_len}
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return out, new_cache


def cross_attention_block(p, cfg, x, enc_kv):
    """Enc-dec cross attention: queries from ``x [B, S, d]`` (no RoPE),
    keys and values precomputed from the encoder (``enc_kv["k"]``/``["v"]``
    ``[B, Se, Hkv, D]``), non-causal, through :func:`chunked_attention`."""
    b, s, _ = x.shape
    hd, hq = cfg.head_dim, cfg.num_heads
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, hd)
    out = on_head_shards(chunked_attention, q, enc_kv["k"], enc_kv["v"], causal=False,
                         chunk=min(cfg.attn_chunk, enc_kv["k"].shape[1]))
    return out.reshape(b, s, hq * hd) @ p["wo"]


def tree_attention_block(p, cfg, x, positions, k_cache, v_cache, kv_len):
    """Frontier attention: ``A`` candidate tokens per row over a READ-ONLY
    dense cache.

    ``x`` is ``[N, A, d]``, the A candidates of each row, all at absolute
    position ``kv_len`` (``positions [N, A]``).  The cache is never
    written: each candidate's own K/V is the speculative tail (identity
    tree mask), read by ``tree_decode_attention`` with the prefix.
    Returns ``(out [N, A, d], k_spec, v_spec)``, the tails ``[N, A, Hkv,
    D]``, for the caller to commit the chosen candidate's row later.
    """
    q, k, v = attention_qkv(p, cfg, x, positions)
    out = tree_decode_attention_kernel(q.contiguous(), k_cache, v_cache, k.contiguous(),
                                       v.contiguous(), kv_len)
    n, a = x.shape[:2]
    return out.reshape(n, a, cfg.num_heads * cfg.head_dim) @ p["wo"], k, v


def paged_tree_attention_block(p, cfg, x, positions, pool_k, pool_v, page_table, kv_len):
    """:func:`tree_attention_block` with the prefix in pools ``[P, bs, Hkv,
    D]`` addressed through ``page_table [N, n_pages]``; the pools are never
    written (``paged_tree_decode_attention`` reads them in place)."""
    q, k, v = attention_qkv(p, cfg, x, positions)
    out = paged_tree_decode_attention_kernel(q.contiguous(), pool_k, pool_v, page_table,
                                             k.contiguous(), v.contiguous(), kv_len)
    n, a = x.shape[:2]
    return out.reshape(n, a, cfg.num_heads * cfg.head_dim) @ p["wo"], k, v


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    std = 0.02
    return {
        "w_gate": normal(gen, (d_model, d_ff), std, dtype),
        "w_up": normal(gen, (d_model, d_ff), std, dtype),
        "w_down": normal(gen, (d_ff, d_model), std, dtype),
    }


def mlp_block(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity-bounded scatter dispatch
# ---------------------------------------------------------------------------


def sorted_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, equal values in ascending index order (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    """The router ``[d, E]`` (float32 whatever ``dtype``, as the
    reference's), the experts' stacked SwiGLU weights ``[E, d, f]`` /
    ``[E, f, d]``, and the fused shared experts (``shared``) if any."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    std = 0.02
    p = {
        "router": normal(gen, (d, e), std, torch.float32),
        "w_gate": normal(gen, (e, d, f), std, dtype),
        "w_up": normal(gen, (e, d, f), std, dtype),
        "w_down": normal(gen, (e, f, d), std, dtype),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = init_mlp(gen, d, cfg.shared_expert_d_ff, dtype)
    return p


def moe_block(p, cfg, x):
    """MoE layer, ``x [B, S, d] -> (out [B, S, d], aux [])``.

    Under a ``DeviceMesh`` whose ``model`` axis is larger than 1 and
    divides ``num_experts``, the routed experts run expert-parallel
    (:func:`_moe_block_sharded`); otherwise (no mesh, one device) the
    local dense-buffer path :func:`_moe_block_local` runs.
    """
    from ..distributed.sharding import _is_device_mesh, ambient_abstract_mesh

    mesh = ambient_abstract_mesh()
    if mesh is not None and _is_device_mesh(mesh) and "model" in mesh.mesh_dim_names:
        tp = mesh.size(mesh.mesh_dim_names.index("model"))
        if tp > 1 and cfg.num_experts % tp == 0:
            out, aux = _moe_block_sharded(p, cfg, x, mesh)
            if "shared" in p:
                out = out + mlp_block(p["shared"], x)
            return out, aux
    return _moe_block_local(p, cfg, x)


def _routed_experts(cfg, x, router, w_gate, w_up, w_down, e_off: int = 0):
    """Route the ``T = B·S`` tokens of ``x [B, S, d]`` over all ``E``
    experts and run those held here, ``w_* [E_loc, ...]`` for experts
    ``e_off .. e_off + E_loc - 1``: ``(out [T, d], aux [])``, ``out`` the
    gate-weighted sum over the local experts' outputs.

    The router product is float32 (the caller keeps TF32 off on the card:
    a flipped top-k sends a token to another expert).  The capacity
    ``ceil(T·k / E · capacity_factor)`` counts the call's tokens.  Each
    (token, choice) for a local expert, in row-major ``[T, k]`` order,
    takes the next free place of its expert (an exclusive cumsum of the
    one-hot); one past the capacity, or a choice of a remote expert, goes to
    the overflow bin ``E_loc·C`` and is dropped.  Experts run as batched
    products ``[E_loc, C, d] @ [E_loc, d, f]``; outputs gather back
    weighted by the renormalised top-k gates.  ``aux`` is the Switch-style
    load-balancing loss.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    e_loc = w_gate.shape[0]
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.float() @ router                                # [T, E]
    if cfg.num_experts_real is not None and cfg.num_experts_real < e:
        dead = torch.arange(e, device=x.device) >= cfg.num_experts_real
        logits = torch.where(dead, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = sorted_top_k(probs, k)              # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    density = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    aux = torch.sum(density * probs.mean(dim=0)) * e * cfg.router_aux_weight

    capacity = int(max(1, math.ceil(t * k / e * cfg.capacity_factor)))
    flat_expert = expert_idx.reshape(-1)                        # [T*k]
    local = (flat_expert >= e_off) & (flat_expert < e_off + e_loc)
    local_e = torch.clamp(flat_expert - e_off, 0, e_loc - 1)
    onehot = torch.where(local[:, None], F.one_hot(local_e, e_loc), 0)   # [T*k, E_loc]
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, local_e[:, None])[:, 0]
    keep = local & (pos < capacity)
    slot = torch.where(keep, local_e * capacity + torch.clamp_max(pos, capacity - 1),
                       e_loc * capacity)                        # overflow bin

    # Kept slots are distinct; only the overflow bin takes several writes.
    buf = x.new_zeros((e_loc * capacity + 1, d))
    buf.index_copy_(0, slot, xt.repeat_interleave(k, dim=0))
    expert_in = buf[: e_loc * capacity].reshape(e_loc, capacity, d)

    h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
    expert_out = torch.bmm(h, w_down)

    flat_out = torch.cat([expert_out.reshape(e_loc * capacity, d), x.new_zeros((1, d))])
    gathered = flat_out[slot].reshape(t, k, d)
    gates = (gate_vals * keep.reshape(t, k)).to(x.dtype)
    return torch.einsum("tkd,tk->td", gathered, gates), aux


def _moe_block_sharded(p, cfg, x, mesh):
    """Expert parallelism: the routed experts of ``p`` (without the shared
    ones) over the ``DeviceMesh`` ``mesh``, the reference's ``shard_map``.

    Tokens stay split over the data axes and whole over ``model``; the
    experts split on their leading axis over ``model``.  Each rank routes
    its rows' tokens over all experts, with the capacity of its own token
    count, and runs its own experts (:func:`_routed_experts`); the combine
    is one all-reduce over ``model``, and ``aux`` is the mean of the ranks'
    over the data axes.  Plain tensors (whole on every rank) are placed
    first, and then the results come back whole.  Returns ``(out [B, S,
    d], aux [])``.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import distribute_leaf

    names = mesh.mesh_dim_names
    data = [a in ("pod", "data") for a in names]
    model = [a == "model" for a in names]
    parts = math.prod(mesh.size(i) for i, a in enumerate(names) if data[i] or model[i])

    def pl(on_data, on_model, other=Replicate()):
        return tuple(on_data if dt else on_model if md else other
                     for dt, md in zip(data, model))

    tok, tok_grad = pl(Shard(0), Replicate()), pl(Shard(0), Partial())
    rep, rep_grad = pl(Replicate(), Replicate()), pl(Partial(), Partial())
    exp, exp_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    out_pl = pl(Shard(0), Partial())
    aux_pl = pl(Partial(), Partial())
    model_dim = model.index(True)

    def inner(xb, router, wg, wu, wd):
        bl, sl, d = xb.shape
        e_off = mesh.get_local_rank(model_dim) * wg.shape[0]
        out, aux = _routed_experts(cfg, *local_inputs(xb, router, wg, wu, wd), e_off)
        # Each rank's share of the mean: summed over every rank below.
        return out.reshape(bl, sl, d), aux / parts

    plain = not is_placed(x)
    args = [x, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    wants = (tok, rep, exp, exp, exp)
    args = [a if is_placed(a) else distribute_leaf(a, w, mesh) for a, w in zip(args, wants)]
    out, aux = local_map(inner, out_placements=(out_pl, aux_pl), in_placements=wants,
                         in_grad_placements=(tok_grad, rep_grad, exp_grad, exp_grad,
                                             exp_grad),
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    out, aux = out.redistribute(mesh, tok), aux.redistribute(mesh, rep)   # EP combine
    if plain:
        return out.full_tensor(), aux.full_tensor()
    return out, aux


def _moe_block_local(p, cfg, x):
    """Single-device MoE with the reference's dense scatter dispatch: every
    expert here (:func:`_routed_experts`), all ``T = B·S`` tokens of the
    call routed together, so the expert capacity and which tokens overflow
    depend on the call's ``[B, S]``, padding and idle rows included; plus
    the shared experts."""
    b, s, d = x.shape
    out, aux = _routed_experts(cfg, x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_block(p["shared"], x)
    return out, aux
