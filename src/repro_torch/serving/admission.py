"""The request-admission path of search serving (counterpart of
``repro.serving.admission``).

A settled tree row of the batched async engine takes the next queued
request in three steps, implemented once here: **validate** the prompt
against the slot's ``[max_len]`` cache row, **prefill** the admitted
prompts in one right-padded ragged forward (``models.prefill_ragged``:
each prompt's cache fills at its own length), and **splice** the rows into
the live engine state (dense: a slot-axis scatter; paged: a block scatter
behind a page-table edit).  The evaluators' ``admit_aux`` hooks route
through these helpers.  The splices write **in place**.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.layers import put_where_


class PromptTooLongError(ValueError):
    """A prompt does not fit its engine's ``[max_len]`` slot cache row.

    Admitting it anyway would write past the row in the dense layout and
    miscount pages in the paged one, so admission rejects it up front.
    """


def validate_prompts(prompts: Sequence[Sequence[int]], max_len: int) -> None:
    """Reject prompts that cannot occupy a ``[max_len]`` slot: a prompt needs
    at least one token and ``len(p) < max_len`` (room for one generated
    token)."""
    empty = [i for i, p in enumerate(prompts) if len(p) == 0]
    if empty:
        raise ValueError(f"prompts {empty} are empty")
    too_long = [i for i, p in enumerate(prompts) if len(p) >= max_len]
    if too_long:
        raise PromptTooLongError(
            f"prompts {too_long} have length >= max_len={max_len}; "
            "leave room for at least one generated token"
        )


def pack_prompts(prompts: Sequence[Sequence[int]],
                 pad_to: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad a prompt list into ``(tokens [R, S], lengths [R])``, int32.

    ``S`` is the longest prompt, rounded up to a multiple of ``pad_to`` when
    given (paged admission pads to whole blocks).
    """
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    s = int(lengths.max())
    if pad_to is not None:
        s = -(-s // pad_to) * pad_to
    tokens = np.zeros((len(prompts), s), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    return tokens, lengths


def ragged_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, lengths: torch.Tensor,
                   s_pad: int):
    """One ragged batched prefill into a fresh ``[R, s_pad]`` dense cache on
    ``tokens``' device.  Returns ``(logits [R, V], cache)``: logits at each
    row's last valid position, cache rows valid up to each row's length."""
    from ..models import init_cache, prefill_ragged

    tokens = tokens.to(torch.int32)
    return prefill_ragged(params, cfg, tokens, lengths.to(torch.int32),
                          init_cache(cfg, tokens.shape[0], s_pad, device=tokens.device))


def splice_dense_slots(cache: dict, slots: torch.Tensor, cache_new: dict) -> dict:
    """Scatter freshly prefilled cache rows into an engine cache's slots, in
    place.  Layer-stacked leaves carry the slot axis at position 1
    (``[L, N, ...]``); ``cache_new`` leaves carry ``R = len(slots)`` there."""
    for name, f in cache.items():
        if isinstance(f, dict):
            splice_dense_slots(f, slots, cache_new[name])
        elif f.dim() > 1:
            f[:, slots] = cache_new[name].to(f.dtype)
    return cache


def splice_pool_pages(pool_k: torch.Tensor, pool_v: torch.Tensor, dense_k: torch.Tensor,
                      dense_v: torch.Tensor, dst: torch.Tensor):
    """Scatter dense ragged-prefill rows into a shared KV block pool, in
    place.

    ``dense_k/v``: ``[L, R, S_pad, Hkv, D]`` with ``S_pad`` a multiple of
    the block size; ``dst``: ``i32[R, S_pad // block_size]`` block ids per
    logical page (the sentinel ``num_blocks`` writes nothing).  The caller
    owns the table edit and the refcounts.
    """
    l_, r_, s_, hk, hd = dense_k.shape
    npg = dst.shape[1]
    bs = s_ // npg
    flat = dst.reshape(-1)
    keep = flat < pool_k.shape[1]
    for pool, dense in ((pool_k, dense_k), (pool_v, dense_v)):
        put_where_(pool, (flat,), dense.reshape(l_, r_ * npg, bs, hk, hd).to(pool.dtype),
                   keep, lead=1)
    return pool_k, pool_v


def pages_needed(length: int, block_size: int) -> int:
    """Logical pages a prefix of ``length`` tokens occupies."""
    return -(-int(length) // block_size)
