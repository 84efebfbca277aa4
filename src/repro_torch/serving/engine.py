"""Batched serving engine: slot-based continuous batching over
``decode_step`` (counterpart of ``repro.serving.engine``).

The engine owns ``B`` request slots.  Prompts are admitted into free slots
by ONE right-padded ragged batch prefill (``prefill_ragged``: each slot's
cache fills at its own length); every tick runs one ``decode_step`` for all
slots; a finished sequence (EOS or the length cap) frees its slot at once,
so no slot waits for the longest request.

The per-slot cache layout (``len`` vector; rows ``>= len`` garbage until
overwritten) is the one :class:`~repro_torch.core.evaluators.CachedModelEvaluator`
shares.  With ``ServeConfig.paged`` the slots draw from a shared KV block
pool (:mod:`repro_torch.models.paged`): admission is a page-table splice,
EOS returns the slot's pages to the pool, and the engine admits fewer
prompts (rather than failing) when the pool is tight.  Recurrent families
(SSM, hybrid) cannot take a right-padded ragged prefill (pad tokens would
enter the state), so they prefill one prompt at a time
(``models.prefill``) into a one-row cache that is spliced into the slot.

Decoding is greedy, or ``rng.categorical`` over ``logits / temperature``
when the temperature is above 0 and :meth:`ServingEngine.step` is given a
key.  The engine runs on CUDA unless ``device`` says otherwise; the cache
and the page bookkeeping live there, the slot bookkeeping on the host.
Every host read goes through :func:`repro_torch.sync.host_read`: one per
tick (the tokens, and a paged pool's exhaustion count with them), one per
admission (the first tokens; a paged admission also reads the free
blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..core.api import resolve_device
from ..models import (
    KV_CACHE_FAMILIES,
    PagePoolExhaustedError,
    alloc_blocks,
    decode_step,
    init_cache,
    init_paged_cache,
    num_pages,
    paged_decode_step,
    prefill,
    prefill_ragged,
    release_pages,
)
from ..models.config import ModelConfig
from ..models.lm import tree_map
from ..sync import host_read
from .admission import (
    PromptTooLongError,
    pack_prompts,
    splice_dense_slots,
    splice_pool_pages,
    validate_prompts,
)

__all__ = ["ServeConfig", "ServingEngine", "PromptTooLongError"]


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 512
    temperature: float = 0.0     # 0 = greedy
    eos_token: int = 0
    # Paged KV (KV-cache families only): slots share one block pool instead
    # of each owning a dense [max_len] row.  num_blocks=None sizes the pool
    # at the dense equivalent; a smaller pool oversubscribes the slots.
    paged: bool = False
    block_size: int = 16
    num_blocks: Optional[int] = None
    # A request also finishes once it has this many tokens (the prefill's
    # first one included; checked after each decode step, as EOS is);
    # None, the reference's behaviour, stops only at EOS or the length cap.
    max_new_tokens: Optional[int] = None


class ServingEngine:
    """``B`` request slots over one model: :meth:`add_requests` admits,
    :meth:`step` decodes one token for every active slot, :meth:`run`
    serves a prompt list to completion."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        b = serve_cfg.batch_slots
        dev = self.device
        if serve_cfg.paged:
            if cfg.family not in KV_CACHE_FAMILIES:
                raise ValueError(f"paged serving needs a KV-cache family "
                                 f"{KV_CACHE_FAMILIES}, not {cfg.family!r}")
            mp = num_pages(serve_cfg.max_len, serve_cfg.block_size)
            self.num_blocks = (serve_cfg.num_blocks if serve_cfg.num_blocks is not None
                               else b * mp)
            pool = init_paged_cache(cfg, b, serve_cfg.max_len,
                                    block_size=serve_cfg.block_size,
                                    num_blocks=self.num_blocks, device=dev)
            self.cache = {"k": pool["k"], "v": pool["v"]}
            # Serving slots never share blocks (independent requests): every
            # allocated block sits at refcount 1, so the refcount vector is
            # the free list.
            self._table = pool["table"]
            self._refcount = pool["refcount"]
        else:
            self.cache = init_cache(cfg, b, serve_cfg.max_len, device=dev)
        self.active = np.zeros(b, bool)
        self.lengths = np.zeros(b, np.int32)
        self.outputs: list[list[int]] = [[] for _ in range(b)]
        self._last_tokens = np.zeros(b, np.int32)

    def blocks_in_use(self) -> int:
        """Pool blocks currently allocated (paged mode only; one host sync)."""
        return int(host_read((self._refcount > 0).sum()))

    def _alloc_tables(self, p_r: torch.Tensor, npg: int) -> torch.Tensor:
        """Admission page schedule: one ``alloc_blocks`` sweep per page
        column hands each admitted prompt its first ``p_r[i]`` blocks."""
        p = self.num_blocks
        dst = torch.full((p_r.shape[0], npg), p, dtype=torch.int32, device=self.device)
        for pi in range(npg):
            need = pi < p_r
            blocks, self._refcount, _ = alloc_blocks(self._refcount, need)
            dst[:, pi] = torch.where(need & (blocks < p), blocks, p)
        return dst

    def _page_step_prep(self, active: torch.Tensor):
        """Per-tick paged bookkeeping: slots entering a fresh logical page
        allocate it (a slot owns its pages, so no copy-on-write); every
        active slot resolves its write target from the table.  Returns
        ``(wb, off, safe, n_fail)``; exhaustion comes back as a count."""
        table = self._table
        b, mp = table.shape
        bs, p = self.sc.block_size, self.num_blocks
        lengths = torch.from_numpy(self.lengths).to(self.device)
        safe = torch.clamp(lengths, 0, self.sc.max_len - 1)
        bi = torch.clamp(safe // bs, 0, mp - 1).to(torch.int64)
        off = safe % bs
        rows = torch.arange(b, device=self.device)
        need = active & (off == 0)
        blocks, self._refcount, n_fail = alloc_blocks(self._refcount, need)
        got = need & (blocks < p)
        newb = torch.where(got, blocks, table[rows, bi])
        table[rows, bi] = newb
        wb = torch.where(active, newb, p)
        return wb, off, safe, n_fail

    def _release_rows(self, mask: np.ndarray) -> None:
        """Return every block of the masked slots to the pool (refcount 1 by
        construction, so one decref frees; sentinel entries drop out)."""
        m = torch.from_numpy(mask).to(self.device)
        hi = torch.where(m, self._table.shape[1], 0)
        self._refcount = release_pages(self._refcount, self._table, torch.zeros_like(hi), hi)
        self._table[m] = self.num_blocks

    def add_request(self, prompt_tokens: list[int]) -> Optional[int]:
        return self.add_requests([prompt_tokens])[0]

    def add_requests(self, prompts: list[list[int]]) -> list[Optional[int]]:
        """Admit up to ``len(free slots)`` prompts with ONE batched prefill
        (recurrent families: one prefill per prompt).

        Returns one slot id (or ``None`` once slots or, paged, pool blocks
        ran out) per prompt, in order.  A prompt that cannot fit a
        ``[max_len]`` slot raises :class:`PromptTooLongError` up front.
        """
        validate_prompts(prompts, self.sc.max_len)
        free = np.flatnonzero(~self.active)
        take = min(len(free), len(prompts))
        admitted: list[Optional[int]] = [None] * len(prompts)
        cfg, sc, dev = self.cfg, self.sc, self.device
        if sc.paged and take:
            # Admit only what the pool holds now, in order (one host sync).
            budget, n_fit = self.num_blocks - self.blocks_in_use(), 0
            for p in prompts[:take]:
                need = -(-len(p) // sc.block_size)
                if need > budget:
                    break
                budget -= need
                n_fit += 1
            take = n_fit
        if take == 0:
            return admitted
        slots = free[:take]
        if cfg.family in KV_CACHE_FAMILIES:
            toks, lengths = pack_prompts(prompts[:take],
                                         pad_to=sc.block_size if sc.paged else None)
            s_pad = toks.shape[1] if sc.paged else sc.max_len
            logits, cache_n = prefill_ragged(self.params, cfg, torch.from_numpy(toks).to(dev),
                                             torch.from_numpy(lengths).to(dev),
                                             init_cache(cfg, take, s_pad, device=dev))
            if sc.paged:
                # Page-table splice: the allocator hands each prompt its
                # pages (the budget check above guarantees they exist), the
                # prefilled rows scatter into the pool, the table points there.
                npg = s_pad // sc.block_size
                p_r = torch.from_numpy(-(-lengths // sc.block_size)).to(dev)
                dst = self._alloc_tables(p_r, npg)
                splice_pool_pages(self.cache["k"], self.cache["v"], cache_n["kv"]["k"],
                                  cache_n["kv"]["v"], dst)
                self._table[torch.from_numpy(slots).to(dev), :npg] = dst
            else:
                splice_dense_slots(self.cache, torch.from_numpy(slots).to(dev), cache_n)
            first = host_read(torch.argmax(logits, dim=-1))
        else:
            firsts = []
            for i, p in enumerate(prompts[:take]):
                cache1 = init_cache(cfg, 1, sc.max_len, device=dev)
                tokens = torch.tensor([p], dtype=torch.int32, device=dev)
                logits, cache1 = prefill(self.params, cfg, {"tokens": tokens}, cache1)
                slot = int(slots[i])

                def put(f, o, slot=slot):
                    if f.dim() > 1:
                        f[:, slot] = o[:, 0].to(f.dtype)

                tree_map(put, {k: v for k, v in self.cache.items() if k != "len"},
                         {k: v for k, v in cache1.items() if k != "len"})
                firsts.append(torch.argmax(logits[0]))
            first = host_read(torch.stack(firsts))
        for i in range(take):
            slot = int(slots[i])
            tok = int(first[i])
            self.active[slot] = True
            self.lengths[slot] = len(prompts[i])
            self.outputs[slot] = [tok]
            self._last_tokens[slot] = tok
            admitted[i] = slot
        # Per-slot lengths: each slot decodes at its own position.
        self.cache["len"] = torch.from_numpy(self.lengths.copy()).to(dev)
        return admitted

    def step(self, key: Optional[torch.Tensor] = None) -> dict[int, int]:
        """One decode tick for all active slots; returns ``{slot: token}``.
        ``key`` (key data ``[2]``) samples at the configured temperature;
        without it, or at temperature 0, decoding is greedy."""
        if not self.active.any():
            return {}
        dev = self.device
        tokens = torch.from_numpy(self._last_tokens).to(dev)
        n_fail = None
        if self.sc.paged:
            active = torch.from_numpy(self.active).to(dev)
            wb, off, safe, n_fail = self._page_step_prep(active)
            att_len = torch.from_numpy(self.lengths + self.active.astype(np.int32)).to(dev)
            run_cache = dict(self.cache, table=self._table, len=att_len, pos=safe,
                             write_block=wb, write_off=off)
            logits, _ = paged_decode_step(self.params, self.cfg, tokens, run_cache)
        else:
            self.cache["len"] = torch.from_numpy(self.lengths.copy()).to(dev)
            logits, self.cache = decode_step(self.params, self.cfg, tokens, self.cache)
        if self.sc.temperature > 0 and key is not None:
            # In the logits' dtype, as the reference divides and draws.
            toks = rng.categorical(key.to(dev), logits / self.sc.temperature)
        else:
            toks = torch.argmax(logits, dim=-1)
        if n_fail is None:
            toks = host_read(toks)
        else:
            # One host read fetches the tokens and the exhaustion count.
            got = host_read(torch.cat([toks.to(torch.int64), n_fail.reshape(1).to(torch.int64)]))
            toks, n_fail = got[:-1], int(got[-1])
            if n_fail:
                # A slot that found no block wrote nothing and did not advance.
                raise PagePoolExhaustedError(f"no free KV block for {n_fail} active "
                                             f"slot(s) (num_blocks={self.num_blocks})")
        emitted = {}
        finished = np.zeros(self.active.shape, bool)
        for slot in np.flatnonzero(self.active):
            t = int(toks[slot])
            emitted[int(slot)] = t
            self.outputs[slot].append(t)
            self._last_tokens[slot] = t
            self.lengths[slot] += 1
            if (t == self.sc.eos_token or self.lengths[slot] >= self.sc.max_len - 1
                    or (self.sc.max_new_tokens is not None
                        and len(self.outputs[slot]) >= self.sc.max_new_tokens)):
                self.active[slot] = False
                finished[slot] = True
        if self.sc.paged and finished.any():
            self._release_rows(finished)
        return emitted

    def run(self, prompts: list[list[int]], max_ticks: int = 256,
            key: Optional[torch.Tensor] = None) -> list[list[int]]:
        """Serve a list of prompts to completion; returns the generated
        tokens per prompt.  With ``key``, tick ``t`` samples with
        ``rng.fold_in(key, t)``; without it decoding is greedy (the
        reference's ``run`` takes no key)."""
        pending = list(enumerate(prompts))
        slot_to_req: dict[int, int] = {}
        results: dict[int, list[int]] = {}
        ticks = 0
        while (pending or self.active.any()) and ticks < max_ticks:
            if pending:
                # One batched prefill admits every prompt a free slot takes.
                slots = self.add_requests([p for _, p in pending])
                n_admitted = 0
                for (req_id, _), slot in zip(pending, slots):
                    if slot is None:
                        break
                    slot_to_req[slot] = req_id
                    n_admitted += 1
                pending = pending[n_admitted:]
            before = self.active.copy()
            self.step(None if key is None else rng.fold_in(key, ticks))
            ticks += 1
            for slot in np.flatnonzero(before & ~self.active):
                results[slot_to_req[int(slot)]] = list(self.outputs[int(slot)])
        for slot, req in slot_to_req.items():
            if req not in results:
                results[req] = list(self.outputs[slot])
        return [results.get(i, []) for i in range(len(prompts))]
