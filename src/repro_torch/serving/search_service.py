"""Token-search service: many users' search requests, one batched program
(counterpart of ``repro.serving.search_service``).

A batch of prompt requests becomes ``B`` root states of one multi-root
search (``build_searcher`` with ``spec.batch = B``), so every master tick
advances all users' searches together and, with the KV-cached evaluator,
evaluates all their in-flight slots in **one** decode step.

* :meth:`SearchService.search` / :meth:`~SearchService.decide`: one-shot,
  a prompt batch run to completion.
* :meth:`SearchService.submit` + :meth:`~SearchService.poll` /
  :meth:`~SearchService.drain` (or :meth:`~SearchService.serve` over a
  request stream): continuous.  A persistent
  :class:`~repro_torch.core.batched_async_search.BatchedAsyncEngine`
  keeps the ``B`` tree rows searching, and a settled row takes the next
  queued request (tree, RNG lane and evaluator slot caches re-seeded
  through :mod:`repro_torch.serving.admission`).  :class:`ServeStats`
  reports the occupancy this buys.

Two ways to pace it.  Fused (the default): each :meth:`~SearchService.poll`
stages queued requests into the engine's request ring (prefilled ahead of
time) and runs one ``serve_segment`` of up to ``ticks_per_segment`` ticks,
in which settled rows are harvested and re-seeded from the ring without
returning here: one host round per segment.  Host-paced (``fused=False``):
each poll harvests, admits and runs up to ``ticks_per_round`` ticks.  Both
give every request the same search.  The service runs on CUDA unless
``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import warnings
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .. import rng
from ..core import SearchResult, SearchSpec, build_searcher
from ..core.api import as_search_config, resolve_device
from ..core.evaluators import CachedModelEvaluator, Evaluator, ModelEvaluator
from ..envs.token_env import TokenEnvState, make_token_env, sorted_top_k
from ..models import logits_at
from ..models.config import ModelConfig
from ..sync import host_copy, host_read
from .admission import pages_needed, validate_prompts

#: Environment variable overriding where the committed benchmark baseline
#: (``BENCH_model_eval.json``) is read from for the paged-pool default.
BENCH_BASELINE_ENV = "REPRO_BENCH_BASELINE"

_pool_fallback_warned = False


class InvalidSearchActionError(RuntimeError):
    """A search returned an action outside ``[0, top_k)``.

    Actions are ranks into the policy's top-K table; an out-of-range value
    (``-1`` from a search that never visited the root's children) has no
    token to map to, and clipping it would serve the greedy top-1 token for
    a failed search.
    """


def _bench_baseline_path() -> Optional[Path]:
    """The committed ``BENCH_model_eval.json``: the :data:`BENCH_BASELINE_ENV`
    variable (a file path), then a walk up from this module's directory,
    then from the working directory; ``None`` when nothing is found."""
    env_path = os.environ.get(BENCH_BASELINE_ENV)
    if env_path:
        p = Path(env_path)
        if p.is_file():
            return p
    seen = set()
    for base in (Path(__file__).resolve().parent, Path.cwd().resolve()):
        for parent in (base, *base.parents):
            if parent in seen:
                continue
            seen.add(parent)
            cand = parent / "BENCH_model_eval.json"
            if cand.is_file():
                return cand
    return None


def _prefix_sharing_pool_blocks(slots: int, max_len: int, block_size: int) -> int:
    """Default paged-pool size from the measured prefix sharing.

    The dense bound ``slots * num_pages`` assumes no page is shared; the
    baseline's ``batch_ceiling`` rows measure the peak working set with
    sibling sharing (``ceiling_ratio`` = dense positions / peak paged
    positions).  The pool is the dense bound shrunk by the worst ratio, plus
    25 % headroom.  Without a readable baseline it is the dense bound, with
    a warning (once when the rows are missing).
    """
    global _pool_fallback_warned
    from ..models import num_pages

    dense = slots * num_pages(max_len, block_size)
    path = _bench_baseline_path()
    ratios = None
    if path is not None:
        try:
            rows = json.loads(path.read_text())["rows"]
            ratios = [float(r["ceiling_ratio"]) for r in rows
                      if r.get("kind") == "batch_ceiling" and "ceiling_ratio" in r]
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.warn(f"could not parse benchmark baseline {path}: {e!r}; "
                          "using the dense paged-pool bound", stacklevel=2)
            return dense
    if not ratios:
        if not _pool_fallback_warned:
            _pool_fallback_warned = True
            warnings.warn("no BENCH_model_eval.json baseline with batch_ceiling rows "
                          f"found (set ${BENCH_BASELINE_ENV} to point at one); using "
                          "the dense paged-pool bound", stacklevel=2)
        return dense
    ratio = min(ratios)
    if not ratio > 1.0:
        return dense
    shrunk = int(dense / ratio * 1.25) + 1
    return max(1, min(dense, shrunk))


@dataclasses.dataclass
class ServeStats:
    """Occupancy and admission counters of continuous serving.

    ``busy_tree_ticks`` counts (tree row, master tick) pairs where the row
    searched; ``ticks * batch`` is the capacity, so :attr:`slot_idle_frac`
    is the share of row-ticks spent idle.  ``host_rounds`` counts
    :meth:`SearchService.poll` rounds (on the fused path one
    ``serve_segment`` each); ``ring_occupancy_sum`` sums the requests
    staged in the ring at each fused round's dispatch, and
    :attr:`ring_occupancy` is its mean.
    """

    batch: int = 0
    submitted: int = 0
    completed: int = 0
    admissions: int = 0
    ticks: int = 0
    busy_tree_ticks: int = 0
    host_rounds: int = 0
    ring_occupancy_sum: int = 0

    @property
    def slot_idle_frac(self) -> float:
        cap = self.ticks * self.batch
        if cap == 0:
            return 0.0
        return 1.0 - self.busy_tree_ticks / cap

    @property
    def ring_occupancy(self) -> float:
        """Mean staged requests per fused host round (0 when host-paced)."""
        if self.host_rounds == 0:
            return 0.0
        return self.ring_occupancy_sum / self.host_rounds


def _key(key, device) -> torch.Tensor:
    """Key data ``[..., 2]`` as the port's int64 words on ``device``."""
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    return key.to(device=device, dtype=torch.int64)


class SearchService:
    """Batched WU-UCT token search behind a prompt-in / token-out interface.

    ``spec.batch`` fixes the request-row count; shorter request lists are
    padded with repeats and the padding results dropped.  ``evaluator=None``
    builds the best evaluator the spec supports: :class:`CachedModelEvaluator`
    on the async engine with a KV-cache model family (its paged subclass
    with ``paged=True``), else the uncached :class:`ModelEvaluator`.

    ``fused`` (the default) serves through the engine's request ring:
    ``ring_capacity`` staged requests at most (default ``B``), up to
    ``ticks_per_segment`` master ticks per :meth:`poll` (default ``8 *
    ticks_per_round``).  With ``fused=False`` each :meth:`poll` runs at
    most ``ticks_per_round`` master ticks before the host harvests settled
    rows and admits queued requests.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        params,
        spec: SearchSpec,
        *,
        top_k: int = 8,
        max_len: int = 64,
        eos_token: int = 0,
        reward_cfg: Optional[ModelConfig] = None,
        reward_params=None,
        evaluator: Optional[Evaluator] = None,
        paged: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        ticks_per_round: int = 8,
        fused: bool = True,
        ring_capacity: Optional[int] = None,
        ticks_per_segment: Optional[int] = None,
        device=None,
    ):
        if spec.batch <= 0:
            raise ValueError("SearchService needs a batched spec (batch > 0)")
        if ticks_per_round < 1:
            raise ValueError(f"ticks_per_round must be >= 1, got {ticks_per_round}")
        for name, value in (("ring_capacity", ring_capacity),
                            ("ticks_per_segment", ticks_per_segment)):
            if value is not None and int(value) < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        self.device = resolve_device(device)
        self.fused = fused
        self.ring_capacity = int(ring_capacity) if ring_capacity is not None else spec.batch
        self.ticks_per_segment = (int(ticks_per_segment) if ticks_per_segment is not None
                                  else 8 * ticks_per_round)
        self.cfg = model_cfg
        self.params = params
        self.spec = spec
        self.top_k = top_k
        self.max_len = max_len
        self.paged = paged
        self.ticks_per_round = ticks_per_round
        # The env's prompt only seeds env.init, which the service bypasses
        # (roots are built from the request prompts).
        env = make_token_env(model_cfg, params, torch.zeros((1,), dtype=torch.int32),
                             max_len=max_len, top_k=top_k, eos_token=eos_token,
                             reward_cfg=reward_cfg, reward_params=reward_params)
        if evaluator is None:
            from ..models import KV_CACHE_FAMILIES

            families = {model_cfg.family} | ({reward_cfg.family} if reward_cfg else set())
            cacheable = spec.engine == "async" and families <= set(KV_CACHE_FAMILIES)
            if paged and not cacheable:
                raise ValueError("paged=True needs an async-engine spec and a KV-cache "
                                 f"model family, got engine={spec.engine!r} "
                                 f"families={sorted(families)}")
            kwargs = dict(top_k=top_k, eos_token=eos_token, reward_cfg=reward_cfg,
                          reward_params=reward_params)
            if paged:
                from ..core.evaluators import PagedCachedModelEvaluator

                if num_blocks is None:
                    num_blocks = _prefix_sharing_pool_blocks(
                        spec.batch * spec.wave_size, max_len, block_size)
                evaluator = PagedCachedModelEvaluator(
                    model_cfg, params, block_size=block_size, num_blocks=num_blocks,
                    **kwargs)
            else:
                ev_cls = CachedModelEvaluator if cacheable else ModelEvaluator
                evaluator = ev_cls(model_cfg, params, **kwargs)
        self.env = env
        self.evaluator = evaluator
        self._search = build_searcher(env, spec, evaluator=evaluator, device=self.device)

        # Continuous-serving state (the engine is built on the first poll).
        self.stats = ServeStats(batch=spec.batch)
        self._engine = None
        self._carry = None
        # Priority-then-FIFO heap of (-priority, req_id, prompt, key): req_id
        # is monotonic, so equal priorities pop in submission order.
        self._queue: list = []
        self._results: dict = {}
        self._row_req: list = [None] * spec.batch
        self._next_req_id = 0
        self._base_key = rng.PRNGKey(0, device=self.device)
        # Fused path: the ring and the rows' request ids on the device, and
        # host mirrors of what is staged and in flight (exact: every change
        # is counted from each round's staged, admitted and completed).
        self._ring = None
        self._row_req_dev = None
        self._ring_free = self.ring_capacity
        self._inflight = 0

    # ------------------------------------------------------------------
    # Root-state packing
    # ------------------------------------------------------------------
    def _root_rows(self, prompts: Sequence[Sequence[int]]) -> TokenEnvState:
        """Pack ``R`` prompts into an ``[R]``-leading root-state batch."""
        validate_prompts(prompts, self.max_len)
        r = len(prompts)
        tokens = np.zeros((r, self.max_len), np.int32)
        lengths = np.zeros((r,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lengths[i] = len(p)
        dev = self.device
        return TokenEnvState(tokens=torch.from_numpy(tokens).to(dev),
                             length=torch.from_numpy(lengths).to(dev),
                             done=torch.zeros((r,), dtype=torch.bool, device=dev))

    def _roots(self, prompts: Sequence[Sequence[int]]) -> TokenEnvState:
        B = self.spec.batch
        if not prompts:
            raise ValueError("need at least one prompt")
        if len(prompts) > B:
            raise ValueError(f"got {len(prompts)} prompts for batch={B}")
        return self._root_rows(list(prompts) + [prompts[0]] * (B - len(prompts)))

    # ------------------------------------------------------------------
    # One-shot serving
    # ------------------------------------------------------------------
    def search(self, prompts: Sequence[Sequence[int]], key) -> SearchResult:
        """One batched search; returns the ``SearchResult`` (leading ``[B]``;
        rows past ``len(prompts)`` are padding)."""
        roots = self._roots(prompts)
        return self._search(roots, rng.split(_key(key, self.device), self.spec.batch))

    def decide(self, prompts: Sequence[Sequence[int]], key):
        """Search + decode: the searched next token of every prompt.

        Actions are ranks into the policy's top-K at each prompt's position;
        one batched forward maps them to vocabulary ids.  An out-of-range
        action on a real request raises :class:`InvalidSearchActionError`.
        """
        n = len(prompts)
        roots = self._roots(prompts)
        res = self._search(roots, rng.split(_key(key, self.device), self.spec.batch))
        actions = res.action.cpu().numpy()
        bad = [(i, int(actions[i])) for i in range(n) if not 0 <= int(actions[i]) < self.top_k]
        if bad:
            raise InvalidSearchActionError(
                f"search returned out-of-range action(s) {bad}; actions are ranks into "
                f"the policy top-{self.top_k} table (the search may not have completed "
                "any simulation from these roots)")
        pos = torch.clamp_min(roots.length.to(torch.int64) - 1, 0)
        _, top_idx = sorted_top_k(logits_at(self.params, self.cfg, roots.tokens, pos),
                                  self.top_k)
        # Padding rows (>= n) were never validated: clip them for the gather.
        ranks = torch.clamp(res.action.to(torch.int64), 0, self.top_k - 1)
        tokens = top_idx.gather(1, ranks[:, None])[:, 0]
        return [int(t) for t in tokens[:n].cpu()], res

    # ------------------------------------------------------------------
    # Continuous serving: persistent engine + row-level admission
    # ------------------------------------------------------------------
    def _ensure_engine(self):
        if self._engine is not None:
            return
        if self.spec.engine != "async":
            raise ValueError("continuous serving (submit/poll/drain/serve) needs an "
                             f"async-engine spec, got engine={self.spec.engine!r}")
        from ..core.batched_async_search import BatchedAsyncEngine

        B = self.spec.batch
        engine = BatchedAsyncEngine(self.env, as_search_config(self.spec), B,
                                    evaluator=self.evaluator)
        # Every row is born idle around a placeholder root and evicted at
        # once, so paged placeholders hold no pool pages.
        roots = self._root_rows([[0]] * B)
        carry = engine.init_carry(roots, rng.split(rng.PRNGKey(0, device=self.device), B),
                                  active=torch.zeros((B,), dtype=torch.bool))
        self._carry = engine.evict(carry, torch.arange(B))
        self._engine = engine
        if self.fused:
            self._ring = engine.init_ring(roots, self.ring_capacity)
            self._row_req_dev = torch.full((B,), -1, dtype=torch.int64, device=self.device)

    def _free_pool_blocks(self) -> Optional[int]:
        """Free blocks of the paged evaluator's pool (``None`` when dense;
        one host sync)."""
        if not self.paged:
            return None
        return int(self.evaluator.num_blocks
                   - host_read((self._carry[7]["refcount"] > 0).sum()))

    def submit(self, prompt: Sequence[int], key=None, priority: int = 0) -> int:
        """Queue one search request; returns its request id.

        ``key`` seeds the request's tree row (default: the service key
        folded with the request id).  Higher ``priority`` admits first;
        ties admit in submission order.  The request runs when a row
        settles: :meth:`poll` makes progress, :meth:`drain` waits for all.
        """
        validate_prompts([prompt], self.max_len)
        req_id = self._next_req_id
        self._next_req_id += 1
        key = rng.fold_in(self._base_key, req_id) if key is None else _key(key, self.device)
        heapq.heappush(self._queue, (-int(priority), req_id, list(prompt), key))
        self.stats.submitted += 1
        return req_id

    def _settled(self) -> np.ndarray:
        """Host copy of the per-row settled mask (one device sync)."""
        return host_read(self._engine.settled(self._carry))

    def _harvest(self, settled: Optional[np.ndarray] = None) -> dict:
        """Collect the results of settled occupied rows and free the rows."""
        if settled is None:
            settled = self._settled()
        done_rows = [b for b in range(self.spec.batch)
                     if settled[b] and self._row_req[b] is not None]
        fresh = {}
        if not done_rows:
            return fresh
        # A host copy (one sync): admission rewrites the rows' buffers in place.
        res = SearchResult(*host_copy(self._engine.result(self._carry)))
        for b in done_rows:
            req_id = self._row_req[b]
            row = SearchResult(*(x[b] for x in res))
            self._results[req_id] = row
            fresh[req_id] = row
            self._row_req[b] = None
            self.stats.completed += 1
        # The rows' pages go back to the pool before anything is admitted.
        self._carry = self._engine.evict(self._carry, torch.tensor(done_rows))
        return fresh

    def _admit_queued(self, settled: Optional[np.ndarray] = None) -> int:
        """Splice queued requests into free rows, in queue order; a paged
        pool admits only as many as its free blocks hold.  One row per
        ``admit`` (one prefill each), as the reference admits and as the
        ring stages: every request's prefill then has the same shape on
        both paths and rounds alike."""
        if settled is None:
            settled = self._settled()
        free_rows = [b for b in range(self.spec.batch)
                     if settled[b] and self._row_req[b] is None]
        if not free_rows or not self._queue:
            return 0
        budget = self._free_pool_blocks()
        admitted = 0
        for b in free_rows:
            if not self._queue:
                break
            _, req_id, prompt, key = self._queue[0]
            if budget is not None:
                need = pages_needed(len(prompt), self.evaluator.block_size)
                if need > budget:
                    break  # wait for pages to free (admit in order)
                budget -= need
            heapq.heappop(self._queue)
            self._carry = self._engine.admit(self._carry, torch.tensor([b]),
                                             self._root_rows([prompt]), key[None])
            self._row_req[b] = req_id
            admitted += 1
        self.stats.admissions += admitted
        return admitted

    def poll(self) -> dict:
        """One serving round; returns the requests that finished in it
        (``{req_id: SearchResult row}``; they also accumulate in
        :attr:`results`).

        Fused: stage queued requests into the ring, run one
        ``serve_segment`` and take its completions.  Host-paced: harvest
        settled rows, admit queued requests, advance the engine up to
        ``ticks_per_round`` master ticks.
        """
        self._ensure_engine()
        if self.fused:
            return self._poll_fused()
        settled = self._settled()
        fresh = self._harvest(settled)
        # Harvest left the freed rows settled: the same host mask serves
        # admission (one device sync per round).
        self._admit_queued(settled)
        if any(r is not None for r in self._row_req):
            self._carry, t, busy = self._engine.run_segment(self._carry,
                                                            self.ticks_per_round)
            self.stats.ticks += int(t)
            self.stats.busy_tree_ticks += int(busy)
        self.stats.host_rounds += 1
        return fresh

    def _poll_fused(self) -> dict:
        """One fused round: refill the ring in priority-then-FIFO order (one
        request per ``stage`` call; a paged pool stages only what its free
        blocks hold), run one segment, take its completions."""
        budget = self._free_pool_blocks()
        while self._queue and self._ring_free > 0:
            _, req_id, prompt, key = self._queue[0]
            if budget is not None:
                need = pages_needed(len(prompt), self.evaluator.block_size)
                if need > budget:
                    break  # wait for pages to free (admit in order)
                budget -= need
            heapq.heappop(self._queue)
            self._carry, self._ring = self._engine.stage(
                self._carry, self._ring, self._root_rows([prompt]), key[None], [req_id])
            self._ring_free -= 1
        staged = self.ring_capacity - self._ring_free
        fresh = {}
        if staged > 0 or self._inflight > 0:
            self._carry, self._ring, self._row_req_dev, comp, t, busy = \
                self._engine.serve_segment(self._carry, self._ring, self._row_req_dev,
                                           self.ticks_per_segment)
            oom = self._carry[7]["oom"] if self.paged else torch.zeros_like(self._ring.count)
            # One host sync; the completion rows then copy without waiting.
            count_after, oom = (int(x) for x in host_read(
                torch.stack([self._ring.count, oom.to(self._ring.count.dtype)])))
            if oom:
                self._engine.check_exhausted(self._carry)
            n = comp.count
            rows = SearchResult(
                action=comp.action[:n].cpu(), root_n=comp.root_n[:n].cpu(),
                root_v=comp.root_v[:n].cpu(), tree_size=comp.tree_size[:n].cpu(),
                dup_selections=torch.zeros((n,), dtype=torch.float32),
                max_o=comp.max_o[:n].cpu(), overflowed=comp.overflowed[:n].cpu(),
                ticks=comp.ticks[:n].cpu())
            for i, req_id in enumerate(comp.req_id[:n].tolist()):
                row = SearchResult(*(x[i] for x in rows))
                self._results[req_id] = row
                fresh[req_id] = row
            admitted = staged - count_after
            self._ring_free = self.ring_capacity - count_after
            self._inflight += admitted - n
            self.stats.admissions += admitted
            self.stats.completed += n
            self.stats.ticks += t
            self.stats.busy_tree_ticks += busy
        self.stats.host_rounds += 1
        self.stats.ring_occupancy_sum += staged
        return fresh

    def drain(self, max_rounds: int = 100_000) -> dict:
        """Poll until every submitted request has a result; return them all.
        ``max_rounds`` bounds the loop against a wedged engine (a paged
        pool too small for even one queued prompt)."""
        self._ensure_engine()
        for _ in range(max_rounds):
            if not self._queue and self._in_flight() == 0:
                break
            before = (len(self._queue), self._in_flight(), self.stats.ticks)
            self.poll()
            after = (len(self._queue), self._in_flight(), self.stats.ticks)
            if after == before:
                raise RuntimeError(f"serving made no progress (queue={after[0]}, in "
                                   f"flight={after[1]}); paged pool too small for the "
                                   "queued prompts?")
        else:
            raise RuntimeError(f"drain exceeded {max_rounds} rounds")
        if not self.fused:
            # One last harvest: the final segment may have settled rows (the
            # fused loop harvests inside the segment).
            self._harvest()
        return dict(self._results)

    def _in_flight(self) -> int:
        """Requests past the queue but short of a result (host-side)."""
        if self.fused:
            return self._inflight + self.ring_capacity - self._ring_free
        return sum(r is not None for r in self._row_req)

    def serve(self, prompt_stream: Iterable[Sequence[int]], keys=None) -> list:
        """Serve a (possibly ragged) request stream to completion: each
        prompt is submitted and a :meth:`poll` round runs between arrivals.
        Returns per-request ``SearchResult`` rows in submission order."""
        ids = []
        for i, prompt in enumerate(prompt_stream):
            ids.append(self.submit(prompt, key=keys[i] if keys is not None else None))
            self.poll()
        results = self.drain()
        return [results[i] for i in ids]

    @property
    def results(self) -> dict:
        """All completed requests so far (``{req_id: SearchResult row}``)."""
        return dict(self._results)
