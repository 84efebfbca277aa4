"""Wrappers of the decode-attention kernels: dense
(``csrc/decode_attention.cu``), paged (``csrc/paged_decode_attention.cu``)
and tree-batched, dense and paged (``csrc/tree_decode_attention.cu``).

CPU tensors go to the plain versions (:mod:`.ref`).  CUDA tensors go to
the hand-written kernels, or the call raises: there is no fallback.  The
kernels launch on PyTorch's current stream, and each wrapper call that
launches adds one to its entry in ``repro_torch.kernels.LAUNCHES``.

The dense and paged kernels split S across blocks where their grid is too
small for the card (:func:`decode_parts`, from shapes only: no host read
of ``kv_len``); ``decode_attention_split`` and
``paged_decode_attention_split`` take the number of parts from the caller
(1: the unsplit kernel) and, on the CPU, run the plain model of the
split.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import LAUNCHES, refuse_grad
from .. import _build
from .ref import (
    SPLIT_KEYS,
    decode_attention_ref,
    decode_attention_split_ref,
    paged_decode_attention_ref,
    paged_decode_attention_split_ref,
    paged_tree_decode_attention_ref,
    part_keys,
    tree_decode_attention_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C_FUNCTIONS: dict[str, object] = {}
# The tree kernels find a candidate's visible tail entries with one warp
# ballot over the A entries.
MAX_CANDIDATES = 32
# All four decode kernels read each key as 16-byte chunks, at most 512
# bytes of one row (float32 rows of up to 256 elements take two per lane).
MAX_DECODE_HEAD_DIM = 256
# Blocks per SM a split grid aims at: each block keeps two key-loop
# iterations of K/V in flight through its cp.async ring (32 KB at bf16
# D=128), so two a SM keep ~8 MB in flight over the card; fewer, longer
# blocks pay less for their start and their merge.
SPLIT_BLOCKS_PER_SM = 2
_SM_COUNTS: dict[int, int] = {}


def decode_parts(blocks: int, limit: int, sms: int) -> int:
    """The number of parts of S a decode call is split into, from shapes
    only: ``blocks`` in the cache's unsplit grid (rows x the cache's KV
    heads x query groups, whatever head window a call asks for, so a
    window splits as the whole call does), its key limit (``S``, or
    ``n_pages * bs``) and the card's SM count.  One part where the
    unsplit grid fills the card or the limit is at most one part's keys;
    else parts of whole :data:`SPLIT_KEYS` keys for about
    :data:`SPLIT_BLOCKS_PER_SM` blocks on every SM (at least 2 parts)."""
    if blocks >= sms or limit <= SPLIT_KEYS:
        return 1
    want = max(2, SPLIT_BLOCKS_PER_SM * sms // blocks)
    return -(-limit // part_keys(limit, want))


def query_groups(group: int) -> int:
    """Blocks a KV head's ``group`` query heads take in the decode grid:
    one per 8 (the body holds 1, 2, 4 or 8 queries a block)."""
    return -(-group // 8)


# ---------------------------------------------------------------------------
# Launch plumbing shared by the wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, kv_len, out, lse, ws; B, S, Hkv, G, D, Hq, q_head0, parts
    "decode_attention": ("decode_attention", [_P] * 7 + [_I] * 8),
    # q, pool_k, pool_v, table, kv_len, out, ws; B, P, bs, n_pages, Hkv, G,
    # D, parts
    "paged_decode_attention": ("paged_decode_attention",
                               [_P] * 7 + [_I] * 8),
    # q, k, v, k_spec, v_spec, kv_len, mask, out; B, A, S, Hkv, G, D
    "tree_decode_attention": ("tree_decode_attention", [_P] * 8 + [_I] * 6),
    # q, pool_k, pool_v, table, k_spec, v_spec, kv_len, mask, out;
    # B, A, P, bs, n_pages, Hkv, G, D
    "paged_tree_decode_attention": ("tree_decode_attention",
                                    [_P] * 9 + [_I] * 8),
}


def _c_function(name: str):
    fn = _C_FUNCTIONS.get(name)
    if fn is None:
        library, head = _SIGNATURES[name]
        fn = getattr(_build.load(library), f"{name}_launch")
        fn.argtypes = head + [ctypes.c_float, _I, _I, _P]
        fn.restype = ctypes.c_int
        _C_FUNCTIONS[name] = fn
    return fn


def _check(name: str, ref: torch.Tensor, **tensors) -> None:
    """Device, dtype and contiguity of the float operands of kernel ``name``."""
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {ref.dtype}")
    for arg, x in tensors.items():
        if x.device != ref.device or x.dtype != ref.dtype:
            raise ValueError(f"{name}: {arg} is {x.dtype} on {x.device}, expected "
                             f"{ref.dtype} on {ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _chunked(name: str, d: int, **tensors) -> None:
    """The 16-byte loads of the decode kernels: ``D`` a multiple of 16
    bytes' worth of elements, at most 256, and every operand 16-byte
    aligned."""
    per_chunk = 16 // next(iter(tensors.values())).element_size()
    if d % per_chunk or d > MAX_DECODE_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of {per_chunk} "
                         f"(16 bytes) and at most {MAX_DECODE_HEAD_DIM}")
    for arg, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _lengths(name: str, kv_len, b: int, device) -> torch.Tensor:
    lens = torch.as_tensor(kv_len, device=device)
    if lens.dtype.is_floating_point or lens.dim() > 1 or lens.numel() not in (1, b):
        raise ValueError(f"{name}: kv_len must be an integer [] or [{b}]")
    return lens.to(torch.int32).reshape(-1).expand(b).contiguous()


def _table(name: str, page_table: torch.Tensor, b: int, device) -> torch.Tensor:
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.dtype.is_floating_point or page_table.device != device):
        raise ValueError(f"{name}: page_table must be an integer [{b}, n_pages] on "
                         f"{device}, got {page_table.dtype} {tuple(page_table.shape)} "
                         f"on {page_table.device}")
    if page_table.shape[1] == 0:
        raise ValueError(f"{name}: page_table has no pages")
    return page_table.to(torch.int32).contiguous()


def _mask(name: str, tree_mask, a: int, device) -> tuple[torch.Tensor | None, int]:
    """The ``[A, A]`` tree mask as int32 on the device and its address; for
    None (the identity) no tensor and a null address, which the kernels
    read as the identity."""
    if tree_mask is None:
        return None, 0
    mask = torch.as_tensor(tree_mask, device=device)
    if tuple(mask.shape) != (a, a):
        raise ValueError(f"{name}: tree_mask must be [{a}, {a}], got {tuple(mask.shape)}")
    mask = mask.to(torch.int32).contiguous()
    return mask, mask.data_ptr()


def _on_cuda(name: str, device) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")
    return True


def _heads(name: str, q_heads: int, pool_shape, q_dim: int) -> tuple[int, int]:
    hkv, d = pool_shape[-2], pool_shape[-1]
    if d != q_dim or hkv == 0 or q_heads % hkv:
        raise ValueError(f"{name}: K/V {tuple(pool_shape)} do not fit {q_heads} query "
                         f"heads of dimension {q_dim}")
    return hkv, q_heads // hkv


def _launch(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = _c_function(name)(*args, index, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def _parts(name: str, parts, blocks: int, limit: int, device) -> int:
    """The caller's number of parts of S, or the plan's where it gave none."""
    if parts is None:
        return decode_parts(blocks, limit, _sm_count(device))
    if isinstance(parts, bool) or int(parts) != parts or parts < 1:
        raise ValueError(f"{name}: parts must be an integer >= 1, got {parts!r}")
    return int(parts)


def _workspace(parts: int, b: int, hq: int, d: int, device) -> tuple[torch.Tensor | None, int]:
    """The split's float32 workspace (each part's out, then its lse) and its
    address; none for one part.  Allocated on the current stream, so a
    captured graph owns it."""
    if parts == 1:
        return None, 0
    ws = torch.empty(parts * b * hq * (d + 1), dtype=torch.float32, device=device)
    return ws, ws.data_ptr()


def _spec_shape(name: str, k_spec, v_spec, b: int, a: int, hkv: int, d: int) -> None:
    want = (b, a, hkv, d)
    for arg, x in (("k_spec", k_spec), ("v_spec", v_spec)):
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: {arg} must be {want}, got {tuple(x.shape)}")
    if a > MAX_CANDIDATES:
        raise ValueError(f"{name} takes at most {MAX_CANDIDATES} candidates, got {a}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len, *, q_head0: int = 0,
                     num_heads: int | None = None, return_lse: bool = False):
    """One-token GQA attention: ``q [B, Hq, D]`` over the first ``kv_len``
    entries of ``k_cache``/``v_cache [B, S, Hkv, D]``; ``kv_len`` is an int
    or an integer tensor ``[]``/``[B]``.  Returns ``[B, Hq, D]`` in
    ``q``'s dtype (float32 or bfloat16, float32 accumulation).  On the card
    ``D`` is a multiple of 16 bytes' worth of elements (8 bf16, 4 float32)
    and at most 256, and the operands are 16-byte aligned; S is split
    across blocks into :func:`decode_parts` parts (one wherever the grid
    fills the card or S is short), merged by log-sum-exp.

    ``q_head0`` and ``num_heads``: ``q`` holds heads ``q_head0 .. q_head0 +
    Hq - 1`` of a model of ``num_heads`` query heads (default: ``Hq``, all
    of them); each reads its KV head from the whole cache in place, and
    equals those heads of a whole call bit for bit (both split S alike).
    ``return_lse``: returns ``(out, lse)``, ``out`` float32 (normalised,
    not rounded to ``q``'s dtype) and ``lse [B, Hq]`` float32, each head's
    log-sum-exp of its scaled scores (``-inf`` where ``kv_len`` is 0);
    without it the output is that ``out`` rounded once."""
    if not _on_cuda("decode_attention", q.device):
        return decode_attention_ref(q, k_cache, v_cache, kv_len, q_head0=q_head0,
                                    num_heads=num_heads, return_lse=return_lse)
    return _decode(q, k_cache, v_cache, kv_len, q_head0, num_heads, return_lse, None)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_len, parts: int, *, q_head0: int = 0,
                           num_heads: int | None = None, return_lse: bool = False):
    """:func:`decode_attention` with S split into ``parts`` parts of
    ``part_keys(S, parts)`` keys (``parts = 1``: the unsplit kernel)
    instead of the plan's; on the CPU the plain model of that split,
    :func:`.ref.decode_attention_split_ref`."""
    if not _on_cuda("decode_attention", q.device):
        return decode_attention_split_ref(q, k_cache, v_cache, kv_len, parts,
                                          q_head0=q_head0, num_heads=num_heads,
                                          return_lse=return_lse)
    return _decode(q, k_cache, v_cache, kv_len, q_head0, num_heads, return_lse, parts)


def _decode(q, k_cache, v_cache, kv_len, q_head0, num_heads, return_lse, parts):
    name = "decode_attention"
    device = q.device
    refuse_grad(name, q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, Hq, D] and the caches "
                         f"[B, S, Hkv, D], got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    s = k_cache.shape[1]
    if k_cache.shape[0] != b:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    total = hq if num_heads is None else num_heads
    hkv, group = _heads(name, total, k_cache.shape, d)
    if not 0 <= q_head0 <= total - hq:
        raise ValueError(f"{name}: heads {q_head0} .. {q_head0 + hq - 1} are not among the "
                         f"model's {total}")
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("decode_attention: k_cache and v_cache differ in shape")
    _check(name, q, q=q, k_cache=k_cache, v_cache=v_cache)
    _chunked(name, d, q=q, k_cache=k_cache, v_cache=v_cache)
    lens = _lengths(name, kv_len, b, device)
    if return_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=device)
        lse = torch.empty((b, hq), dtype=torch.float32, device=device)
    else:
        out, lse = torch.empty_like(q), None
    if b == 0 or hq == 0:
        return (out, lse) if return_lse else out
    parts = _parts(name, parts, b * hkv * query_groups(group), s, device)
    ws, ws_ptr = _workspace(parts, b, hq, d, device)  # ws lives until the launch
    _launch(name, device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(), ws_ptr,
            b, s, hkv, group, d, hq, q_head0, parts, 1.0 / math.sqrt(d), _DTYPES[q.dtype])
    return (out, lse) if return_lse else out


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           page_table: torch.Tensor, kv_len) -> torch.Tensor:
    """One-token GQA attention, ``q [B, Hq, D]``, over the first ``kv_len``
    keys of each row, read from pools ``[P, bs, Hkv, D]`` through
    ``page_table i32[B, n_pages]`` (key ``t`` at ``(table[b, t // bs],
    t % bs)``; entries past the live pages are never read).  Returns
    ``[B, Hq, D]`` in ``q``'s dtype, computed as :func:`decode_attention`
    computes it over ``n_pages * bs`` keys, split into the same parts; on
    the card ``D`` and the alignment are as there."""
    if not _on_cuda("paged_decode_attention", q.device):
        return paged_decode_attention_ref(q, pool_k, pool_v, page_table, kv_len)
    return _paged(q, pool_k, pool_v, page_table, kv_len, None)


def paged_decode_attention_split(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, page_table: torch.Tensor, kv_len,
                                 parts: int) -> torch.Tensor:
    """:func:`paged_decode_attention` with its ``n_pages * bs`` keys split
    into ``parts`` parts (``parts = 1``: the unsplit kernel) instead of the
    plan's; on the CPU :func:`.ref.paged_decode_attention_split_ref`."""
    if not _on_cuda("paged_decode_attention", q.device):
        return paged_decode_attention_split_ref(q, pool_k, pool_v, page_table, kv_len, parts)
    return _paged(q, pool_k, pool_v, page_table, kv_len, parts)


def _paged(q, pool_k, pool_v, page_table, kv_len, parts):
    name = "paged_decode_attention"
    device = q.device
    refuse_grad(name, q, pool_k, pool_v)
    if q.dim() != 3 or pool_k.dim() != 4 or tuple(pool_v.shape) != tuple(pool_k.shape):
        raise ValueError(f"{name}: q must be [B, Hq, D] and both pools [P, bs, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)}")
    b, hq, d = q.shape
    p, bs = pool_k.shape[:2]
    hkv, group = _heads(name, hq, pool_k.shape, d)
    _check(name, q, q=q, pool_k=pool_k, pool_v=pool_v)
    _chunked(name, d, q=q, pool_k=pool_k, pool_v=pool_v)
    table = _table(name, page_table, b, device)
    lens = _lengths(name, kv_len, b, device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    if p == 0 or bs == 0:
        raise ValueError(f"{name}: empty pool {tuple(pool_k.shape)}")
    n_pages = table.shape[1]
    parts = _parts(name, parts, b * hkv * query_groups(group), n_pages * bs, device)
    ws, ws_ptr = _workspace(parts, b, hq, d, device)  # ws lives until the launch
    _launch(name, device, q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), ws_ptr, b, p, bs, n_pages,
            hkv, group, d, parts, 1.0 / math.sqrt(d), _DTYPES[q.dtype])
    return out


def tree_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k_spec: torch.Tensor, v_spec: torch.Tensor, kv_len,
                          tree_mask=None) -> torch.Tensor:
    """Tree-batched speculative decode: ``q [B, A, Hq, D]`` (A candidates
    per row) over the row's first ``kv_len`` cache entries (``[B, S, Hkv,
    D]``, read once for all candidates) plus the tail ``k_spec``/``v_spec
    [B, A, Hkv, D]`` under ``tree_mask [A, A]`` (None: the identity).
    Returns ``[B, A, Hq, D]`` in ``q``'s dtype; with the identity mask,
    candidate ``a``'s output is :func:`decode_attention`'s over the cache
    with entry ``a`` appended, bit for bit.  On the card ``D`` and the
    alignment are as for :func:`decode_attention`."""
    name = "tree_decode_attention"
    device = q.device
    if not _on_cuda(name, device):
        return tree_decode_attention_ref(q, k_cache, v_cache, k_spec, v_spec, kv_len,
                                         tree_mask)
    refuse_grad(name, q, k_cache, v_cache, k_spec, v_spec)
    if q.dim() != 4 or k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"{name}: q must be [B, A, Hq, D] and both caches [B, S, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, a, hq, d = q.shape
    s = k_cache.shape[1]
    if k_cache.shape[0] != b:
        raise ValueError(f"{name}: caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)}")
    hkv, group = _heads(name, hq, k_cache.shape, d)
    _spec_shape(name, k_spec, v_spec, b, a, hkv, d)
    _check(name, q, q=q, k_cache=k_cache, v_cache=v_cache, k_spec=k_spec, v_spec=v_spec)
    _chunked(name, d, q=q, k_cache=k_cache, v_cache=v_cache, k_spec=k_spec, v_spec=v_spec)
    lens = _lengths(name, kv_len, b, device)
    mask, mask_ptr = _mask(name, tree_mask, a, device)  # mask lives until the launch
    out = torch.empty_like(q)
    if b == 0 or a == 0:
        return out
    if s == 0:
        raise ValueError(f"{name}: empty cache {tuple(k_cache.shape)}")
    _launch(name, device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_spec.data_ptr(), v_spec.data_ptr(), lens.data_ptr(), mask_ptr,
            out.data_ptr(), b, a, s, hkv, group, d, 1.0 / math.sqrt(d),
            _DTYPES[q.dtype])
    return out


def paged_tree_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                                pool_v: torch.Tensor, page_table: torch.Tensor,
                                k_spec: torch.Tensor, v_spec: torch.Tensor, kv_len,
                                tree_mask=None) -> torch.Tensor:
    """:func:`tree_decode_attention` with the prefix read from pools
    ``[P, bs, Hkv, D]`` through ``page_table i32[B, n_pages]``, as
    :func:`paged_decode_attention` reads it."""
    name = "paged_tree_decode_attention"
    device = q.device
    if not _on_cuda(name, device):
        return paged_tree_decode_attention_ref(q, pool_k, pool_v, page_table, k_spec,
                                               v_spec, kv_len, tree_mask)
    refuse_grad(name, q, pool_k, pool_v, k_spec, v_spec)
    if q.dim() != 4 or pool_k.dim() != 4 or tuple(pool_v.shape) != tuple(pool_k.shape):
        raise ValueError(f"{name}: q must be [B, A, Hq, D] and both pools "
                         f"[P, bs, Hkv, D], got {tuple(q.shape)}, {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)}")
    b, a, hq, d = q.shape
    p, bs = pool_k.shape[:2]
    hkv, group = _heads(name, hq, pool_k.shape, d)
    _spec_shape(name, k_spec, v_spec, b, a, hkv, d)
    _check(name, q, q=q, pool_k=pool_k, pool_v=pool_v, k_spec=k_spec, v_spec=v_spec)
    _chunked(name, d, q=q, pool_k=pool_k, pool_v=pool_v, k_spec=k_spec, v_spec=v_spec)
    table = _table(name, page_table, b, device)
    lens = _lengths(name, kv_len, b, device)
    mask, mask_ptr = _mask(name, tree_mask, a, device)  # mask lives until the launch
    out = torch.empty_like(q)
    if b == 0 or a == 0:
        return out
    if p == 0 or bs == 0:
        raise ValueError(f"{name}: empty pool {tuple(pool_k.shape)}")
    _launch(name, device, q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), k_spec.data_ptr(), v_spec.data_ptr(), lens.data_ptr(),
            mask_ptr, out.data_ptr(), b, a, p, bs, table.shape[1], hkv, group, d,
            1.0 / math.sqrt(d), _DTYPES[q.dtype])
    return out
