"""Evaluators: the pluggable leaf-evaluation side of parallel MCTS
(counterpart of ``repro.core.evaluators``).

Engines drive their in-flight slots through an :class:`Evaluator` instead
of calling ``env.policy``/``env.step`` themselves.  The port's methods
take a batch ``[N]`` of slots where the reference's are ``vmap``\\ ped:

* ``tick(cfg, kind, act, state, rollout_done, acc, disc, steps, keys, aux)``
  advances ``N`` in-flight slots by one environment step;
* ``rollout(cfg, state, already_done, keys)`` returns the discounted
  simulation return ``f32[N]`` of ``N`` independent rollouts;
* the slot-aux hooks (``init_aux``, ``refill_aux``, ``aux_len``,
  ``aux_last_logits``) and ``init_state`` serve the async engines, which
  carry evaluator-owned per-slot state (the KV cache) beside their slots.

Rollouts are masked lockstep loops: all ``N`` slots step together until
none is live, which is what ``vmap`` of the reference's per-slot
``while_loop`` computes.  Each step costs one host sync.

The evaluators: :class:`RolloutEvaluator` (``env.policy`` rollouts),
:class:`ModelEvaluator` (one batched LM ``forward`` per tick over the token
environment), :class:`CachedModelEvaluator` (one batched ``decode_step``
per tick against per-slot KV caches), :class:`PagedCachedModelEvaluator`
(the same over a shared block pool with page tables), and the
frontier-speculative :class:`FrontierModelEvaluator` and
:class:`PagedFrontierModelEvaluator` (an EXPAND tick scores every
candidate child in one forward; refills onto the snapshot parent or one
of its children need no forward).  The serving hooks ``admit_aux`` and
``evict_aux`` re-seed and release the rows of the host-paced search
service; ``init_ring_aux``, ``stage_ring_aux``, ``admit_aux_from_ring``
and ``evict_aux_to_ring`` do the same for its fused request ring.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state, where_state
from ..models.layers import put_where_
from ..sync import host_any

State = Any

# Slot phases, shared with the async engines.
FREE, EXPAND, SIM = 0, 1, 2


def slot_accounting(gamma, kind, nxt, state, r, done, rollout_done, acc, disc,
                    steps):
    """Per-slot discounted-return bookkeeping after one environment step:
    only live SIM slots accumulate, FREE slots keep their state, EXPAND
    slots report the edge transition."""
    is_sim = kind == SIM
    live = is_sim & ~rollout_done
    acc = acc + torch.where(live, disc * r, 0.0)
    disc = torch.where(live, disc * gamma, disc)
    busy = kind != FREE
    steps = steps + busy.to(steps.dtype)
    new_state = where_state(busy, nxt, state)
    rollout_done = torch.where(kind == EXPAND, done, rollout_done | (is_sim & done))
    return new_state, r, done, acc, disc, steps, rollout_done


def _flat_slot_rows(rows: torch.Tensor, w: int) -> torch.Tensor:
    """Flat aux rows ``[R·w]`` of tree rows ``rows``' ``w`` sibling slots
    (slot ``j`` of tree ``b`` lives at flat aux row ``b·w + j``)."""
    rows = rows.to(torch.int64)
    return (rows[:, None] * w + torch.arange(w, device=rows.device)[None, :]).reshape(-1)


class Evaluator:
    """Protocol for environment/model evaluation inside a search engine.

    ``cfg`` is the engine's ``SearchConfig`` (only ``gamma``,
    ``max_sim_steps`` and ``value_mix`` are read).  ``aux`` is the
    evaluator-owned per-slot state of the async engines; the default hooks
    make it an empty tuple, so stateless evaluators pass it through:

    * ``init_aux(root_states, prefix)`` builds the flat ``[N]`` aux pool
      (``N = prod(prefix)``; root leaves lead with ``prefix[:-1]`` and
      broadcast over the trailing slot axis);
    * ``refill_aux(cfg, aux, rows, new_state, mask)`` re-syncs aux rows
      ``rows`` with the freshly assigned ``new_state`` where ``mask``
      holds; returns ``(aux, hits)``, ``hits`` marking the rows a frontier
      cache answered (all false for the other evaluators);
    * ``aux_len(aux)`` / ``aux_last_logits(aux)`` / ``aux_blocks(aux)``:
      per-slot cache depth, last logits and the pool blocks in use, ``None``
      where the evaluator keeps none;
    * ``admit_aux(cfg, aux, rows, root_states, w)`` re-seeds the slots of
      freshly admitted tree rows ``rows`` (``i64[R]``; flat aux rows
      ``b·w .. b·w + w - 1``) from their root states (leaves lead with
      ``[R]``), and ``evict_aux(aux, rows, w)`` releases what settled tree
      rows hold: the serving layer's half of continuous batching.
      Stateless evaluators and the uncached model need neither;
    * the request ring's hooks (``BatchedAsyncEngine.serve_segment``) split
      ``admit_aux`` at the prefill: ``init_ring_aux(cfg, proto_root_states,
      capacity)`` builds empty per-request staging buffers;
      ``stage_ring_aux(cfg, aux, ring_aux, slots, root_states)`` prefills
      requests into ring slots ``slots`` between segments (paged: pool
      pages allocated from ``aux``'s refcounts and held by the ring) and
      returns ``(aux, ring_aux)``; ``admit_aux_from_ring(cfg, aux,
      ring_aux, slot, rows, w)`` splices staged slots ``slot`` into tree
      rows ``rows`` inside the tick loop and returns ``(aux, ring_aux)``;
      ``evict_aux_to_ring(aux, rows, w)`` releases settled rows there and
      never raises (a paged pool latches ``oom``).  Evaluators without
      per-request resources stage nothing.

    ``slot_aux`` says whether the evaluator carries slot aux at all.  When
    the batched async engine's ``constrain`` hook splits the ``B`` trees
    over the data ranks, each rank's aux holds its own trees' rows only,
    and :meth:`for_shard` gives the evaluator of that share.  The engine
    hands every hook of a split carry that share's evaluator, the rank's
    own rows as local ids (``rows - lo``) and their root states only, and
    the ring hooks the rank's ring share: the hooks stay as they are.
    """

    env: Optional[Environment] = None
    slot_aux = False

    def for_shard(self, parts: int, reduce_sum: Callable) -> "Evaluator":
        """The evaluator of one data rank's share of the slot aux, the
        ``B`` trees split over ``parts`` ranks; ``reduce_sum(x)`` sums a
        one-element tensor over those ranks.  Every hook then takes the
        rank's rows only, with local row ids.  Dense per-slot state needs
        nothing more, so the default is this evaluator."""
        del parts, reduce_sum
        return self

    def init_aux(self, root_states: State, prefix: tuple):
        del root_states, prefix
        return ()

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg, new_state, mask
        return aux, torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)

    def admit_aux(self, cfg, aux, rows, root_states, w):
        del cfg, rows, root_states, w
        return aux

    def evict_aux(self, aux, rows, w):
        del rows, w
        return aux

    def init_ring_aux(self, cfg, proto_root_states, capacity: int):
        del cfg, proto_root_states, capacity
        return ()

    def stage_ring_aux(self, cfg, aux, ring_aux, slots, root_states):
        del cfg, slots, root_states
        return aux, ring_aux

    def admit_aux_from_ring(self, cfg, aux, ring_aux, slot, rows, w):
        del cfg, slot, rows, w
        return aux, ring_aux

    def evict_aux_to_ring(self, aux, rows, w):
        """The in-loop eviction: by row index, as :meth:`evict_aux` already
        is (neither raises)."""
        return self.evict_aux(aux, rows, w)

    def aux_blocks(self, aux) -> Optional[torch.Tensor]:
        del aux
        return None

    def check_exhausted(self, aux) -> None:
        """Nothing to exhaust: only a paged pool runs out."""
        del aux

    def aux_len(self, aux) -> Optional[torch.Tensor]:
        del aux
        return None

    def aux_last_logits(self, aux) -> Optional[torch.Tensor]:
        del aux
        return None

    def init_state(self, example_state: State, prefix: tuple) -> State:
        """Zeroed per-slot state buffers shaped ``prefix + leaf.shape``."""
        return map_state(
            lambda x: torch.zeros(tuple(prefix) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device),
            example_state,
        )

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        raise NotImplementedError

    def value(self, state: State) -> torch.Tensor:
        return torch.zeros(state[0].shape[0], dtype=torch.float32,
                           device=state[0].device)

    def has_value(self) -> bool:
        """Whether :meth:`value` is a real estimator; gates the truncation
        bootstrap and ``value_mix`` blending."""
        return False

    def rollout(self, cfg, state, already_done, keys) -> torch.Tensor:
        """Default full rollouts: tick ``N`` SIM slots in lockstep until each
        is done or at the step cap (the reference ``vmap``\\ s its per-slot
        ``while_loop`` of single-slot ticks; rows that stop keep their
        carry).  Model evaluators get their rollouts from this."""
        n = already_done.shape[0]
        device = already_done.device
        st, done = state, already_done.clone()
        acc = torch.zeros((n,), dtype=torch.float32, device=device)
        disc = torch.ones((n,), dtype=torch.float32, device=device)
        steps = torch.zeros((n,), dtype=torch.int32, device=device)
        kind = torch.full((n,), SIM, dtype=torch.int32, device=device)
        act = torch.zeros((n,), dtype=torch.int32, device=device)
        while True:
            live = ~done & (steps < cfg.max_sim_steps)
            if not host_any(live):
                break
            ks = rng.split(keys)
            (st2, _, _, acc2, disc2, steps2, done2), _ = self.tick(
                cfg, kind, act, st, done, acc, disc, steps, ks[:, 1])
            st = where_state(live, st2, st)
            acc = torch.where(live, acc2, acc)
            disc = torch.where(live, disc2, disc)
            steps = torch.where(live, steps2, steps)
            done = torch.where(live, done2, done)
            keys = torch.where(live[:, None], ks[:, 0], keys)
        ret = acc
        if self.has_value():
            ret = ret + disc * torch.where(done, 0.0, self.value(st))
            if cfg.value_mix > 0.0:
                v0 = torch.where(already_done, 0.0, self.value(state))
                ret = (1.0 - cfg.value_mix) * ret + cfg.value_mix * v0
        return ret


class RolloutEvaluator(Evaluator):
    """Classic rollout evaluation: ``env.policy`` acts, ``env.step``
    advances; the reference's default, draw for draw."""

    def __init__(self, env: Environment):
        self.env = env

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        env = self.env
        pol_act = env.policy(keys, state).to(torch.int64)
        a = torch.where(kind == EXPAND, act.to(torch.int64), pol_act)
        nxt, r, done = env.step(state, a)
        out = slot_accounting(cfg.gamma, kind, nxt, state, r, done, rollout_done,
                              acc, disc, steps)
        return out, aux

    def rollout(self, cfg, state, already_done, keys) -> torch.Tensor:
        """Discounted simulation returns with optional value bootstrap and
        mixing (paper Fig. 1(a) "simulation"; App. D truncation)."""
        env = self.env
        n = already_done.shape[0]
        device = already_done.device
        st, done = state, already_done.clone()
        acc = torch.zeros((n,), dtype=torch.float32, device=device)
        disc = torch.ones((n,), dtype=torch.float32, device=device)
        steps = torch.zeros((n,), dtype=torch.int32, device=device)
        while True:
            live = ~done & (steps < cfg.max_sim_steps)
            if not host_any(live):
                break
            ks = rng.split(keys)
            a = env.policy(ks[:, 1], st)
            nxt, r, d = env.step(st, a)
            acc = torch.where(live, acc + disc * r, acc)
            disc = torch.where(live, disc * cfg.gamma, disc)
            st = where_state(live, nxt, st)
            done = torch.where(live, done | d, done)
            keys = torch.where(live[:, None], ks[:, 0], keys)
            steps = steps + live.to(torch.int32)

        if env.value_fn is not None:
            # Truncation bootstrap: R_simu = Σ γ^i r_i + γ^T V(s_T) (App. D).
            acc = acc + disc * torch.where(done, 0.0, env.value_fn(st))
            if cfg.value_mix > 0.0:
                v0 = torch.where(already_done, 0.0, env.value_fn(state))
                acc = (1.0 - cfg.value_mix) * acc + cfg.value_mix * v0
        return acc

    def value(self, state: State) -> torch.Tensor:
        if self.env.value_fn is None:
            return super().value(state)
        return self.env.value_fn(state)

    def has_value(self) -> bool:
        return self.env.value_fn is not None


# ---------------------------------------------------------------------------
# ModelEvaluator — one batched policy/value LM forward per tick.
# ---------------------------------------------------------------------------


class ModelEvaluator(Evaluator):
    """LM-backed evaluation over token-environment state batches.

    One ``forward`` over the whole in-flight slot batch per tick gives all
    three quantities the token environment's ``step`` and ``policy`` need:
    the top-K table (action decoding), the sampled simulation action and
    the reward log-prob (a distinct reward model adds one more forward).
    Transitions apply :func:`repro_torch.envs.token_env.apply_token`, the
    environment's own transition core, so the search explores the same MDP.

    The simulation action is ``rng.categorical`` over the top-K values with
    the slot's key, in the model's dtype, as the reference draws it (a
    bfloat16 model draws bfloat16 Gumbel noise).
    """

    slot_aux = True

    def __init__(
        self,
        model_cfg,
        params,
        *,
        top_k: int,
        eos_token: int = 0,
        reward_cfg=None,
        reward_params=None,
        value_fn: Optional[Callable] = None,
    ):
        self.model_cfg = model_cfg
        self.params = params
        self.top_k = top_k
        self.eos_token = eos_token
        self.reward_cfg = reward_cfg if reward_cfg is not None else model_cfg
        self.reward_params = reward_params
        self.value_fn = value_fn

    def _position_logits(self, params, cfg, tokens, lengths) -> torch.Tensor:
        """Logits at each slot's current position — ONE forward for [N]."""
        from ..models import logits_at

        return logits_at(params, cfg, tokens, torch.clamp_min(lengths - 1, 0))

    def _transition(self, cfg, kind, act, state, rollout_done, acc, disc,
                    steps, keys, pol_logits, rew_logits):
        """Logits -> (action, token, reward) -> env transition -> accounting;
        shared with :class:`CachedModelEvaluator`."""
        from ..envs.token_env import apply_token, sorted_top_k

        top_vals, top_idx = sorted_top_k(pol_logits, self.top_k)
        ranks = rng.categorical(keys, top_vals)
        a = torch.where(kind == EXPAND, act.to(torch.int64), ranks)
        token = top_idx.gather(1, torch.clamp(a, 0, self.top_k - 1)[:, None])[:, 0]
        logp = torch.log_softmax(rew_logits.float(), dim=-1).gather(1, token[:, None])[:, 0]
        nxt, r, done = apply_token(state, token, logp, self.eos_token)
        out = slot_accounting(cfg.gamma, kind, nxt, state, r, done, rollout_done,
                              acc, disc, steps)
        return out, token

    def init_aux(self, root_states: State, prefix: tuple):
        """Per-slot ``last_logits`` slab: the logits each tick computes."""
        n = math.prod(int(p) for p in prefix)
        return {"last_logits": torch.zeros((n, self.model_cfg.vocab_size),
                                           dtype=torch.float32,
                                           device=root_states[0].device)}

    def aux_last_logits(self, aux) -> Optional[torch.Tensor]:
        if isinstance(aux, dict) and "last_logits" in aux:
            return aux["last_logits"]
        return None

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        # --- the one batched forward of this tick ---------------------------
        pol = self._position_logits(self.params, self.model_cfg, state.tokens,
                                    state.length)
        if self.reward_params is None:
            rew = pol
        else:
            rew = self._position_logits(self.reward_params, self.reward_cfg,
                                        state.tokens, state.length)
        out, _ = self._transition(cfg, kind, act, state, rollout_done, acc, disc,
                                  steps, keys, pol, rew)
        if isinstance(aux, dict) and "last_logits" in aux:
            aux = dict(aux, last_logits=pol.to(aux["last_logits"].dtype))
        return out, aux

    def value(self, state: State) -> torch.Tensor:
        if self.value_fn is None:
            return super().value(state)
        return self.value_fn(state)

    def has_value(self) -> bool:
        return self.value_fn is not None


# ---------------------------------------------------------------------------
# CachedModelEvaluator — one batched decode step per tick.
# ---------------------------------------------------------------------------


class CachedModelEvaluator(ModelEvaluator):
    """:class:`ModelEvaluator` with a per-slot KV decode cache in slot aux.

    A tick costs one batched ``decode_step`` over all ``[N]`` in-flight
    slots, whose attention runs the ``decode_attention`` kernel with the
    per-slot ragged ``len`` vector.  Aux layout (flat slot axis ``N``; the
    cache leaves carry ``N`` on axis 1 under the layer axis):

    * ``tokens  i32[N, S]`` — the tokens fed into the cache (valid ``< len``);
    * ``len     i32[N]``    — tokens processed per slot;
    * ``pol``/``rew`` — per model, the KV cache (without ``len``) and the
      stored logits ``[N, V]`` at each slot's current position (``rew`` is
      ``()`` when the reward model is the policy model).

    **Prefix-aware refill** (:meth:`refill_aux`): a slot handed a new tree
    path rolls ``len`` back to the common prefix with the tokens it already
    processed and re-decodes the divergent suffix in ragged chunks of
    ``refill_chunk`` tokens (``decode_chunk``); the last prompt token is
    always re-decoded, so the stored logits are the new position's.

    Garbage rows: K/V at positions ``>= len`` are invalid; attention masks
    them, and every write lands at ``len`` before ``len`` moves past it.
    Slots that are not fed still decode, writing at ``min(len, S - 1)``.

    **In place:** the hooks update the aux tensors they are given and
    return the same dict: ``_advance`` writes each slot's token and K/V row
    (through ``decode_step``); ``refill_aux`` works on a copy of the rows
    (gathered by index) and writes the finished rows back at the end, so
    no later read sees a half-written row.

    Async engines only: the wave engines carry no slot aux
    (``build_searcher`` enforces this).
    """

    def __init__(
        self,
        model_cfg,
        params,
        *,
        top_k: int,
        eos_token: int = 0,
        reward_cfg=None,
        reward_params=None,
        value_fn: Optional[Callable] = None,
        refill_chunk: int = 8,
    ):
        super().__init__(model_cfg, params, top_k=top_k, eos_token=eos_token,
                         reward_cfg=reward_cfg, reward_params=reward_params,
                         value_fn=value_fn)
        if refill_chunk < 1:
            raise ValueError(f"refill_chunk must be >= 1, got {refill_chunk}")
        self.refill_chunk = refill_chunk
        from ..models import KV_CACHE_FAMILIES

        cfgs = [model_cfg] + ([self.reward_cfg] if reward_params is not None else [])
        for c in cfgs:
            if c.family not in KV_CACHE_FAMILIES:
                raise ValueError(
                    "CachedModelEvaluator needs a rollback-able KV cache; "
                    f"family {c.family!r} carries recurrent state (use ModelEvaluator)"
                )

    # -- aux structure helpers ---------------------------------------------

    def _branches(self):
        """(aux key, params, cfg) per model the cache tracks."""
        out = [("pol", self.params, self.model_cfg)]
        if self.reward_params is not None:
            out.append(("rew", self.reward_params, self.reward_cfg))
        return out

    @staticmethod
    def _take_rows(aux, rows):
        """A copy of aux rows ``rows`` (advanced indexing gathers)."""
        from ..models.lm import tree_map

        def branch(b):
            if not isinstance(b, dict):
                return ()
            return {"cache": tree_map(lambda x: x[:, rows], b["cache"]),
                    "logits": b["logits"][rows]}

        return {"tokens": aux["tokens"][rows], "len": aux["len"][rows],
                "pol": branch(aux["pol"]), "rew": branch(aux["rew"])}

    @staticmethod
    def _put_rows(aux, rows, sub):
        """Write ``sub`` back into aux rows ``rows``, in place."""
        from ..models.lm import tree_map

        def put(x, y):
            x[:, rows] = y

        aux["tokens"][rows] = sub["tokens"]
        aux["len"][rows] = sub["len"]
        for key in ("pol", "rew"):
            if isinstance(aux[key], dict):
                tree_map(put, aux[key]["cache"], sub[key]["cache"])
                aux[key]["logits"][rows] = sub[key]["logits"]
        return aux

    def _advance(self, aux, token, fed):
        """Feed one token per slot through the cached models.

        Every slot decodes (ONE batched ``decode_step`` per model); only
        ``fed`` slots commit: their ``len`` advances and their stored
        logits refresh.  Other slots' K/V writes land at their own position
        ``min(len, S - 1)``, the garbage region, overwritten before ``len``
        moves past it.
        """
        from ..models import decode_step

        length = aux["len"]
        _, safe = self._write_tokens(aux, token, fed)
        for key, params, cfg in self._branches():
            b = aux[key]
            logits, cache = decode_step(params, cfg, token, dict(b["cache"], len=safe))
            cache.pop("len")
            aux[key] = {
                "cache": cache,
                "logits": torch.where(fed[:, None], logits, b["logits"]).to(b["logits"].dtype),
            }
        aux["len"] = torch.where(fed, length + 1, length)
        return aux

    @staticmethod
    def _write_tokens(aux, token, fed):
        """Write each ``fed`` slot's token at its position ``min(len, S - 1)``
        of ``aux['tokens']`` (in place); returns ``(idx, safe)``, the slot
        indices and those positions."""
        idx = torch.arange(token.shape[0], device=token.device)
        safe = torch.clamp_max(aux["len"], aux["tokens"].shape[-1] - 1)
        prev = aux["tokens"][idx, safe]
        aux["tokens"][idx, safe] = torch.where(fed, token.to(prev.dtype), prev)
        return idx, safe

    # -- evaluator protocol -------------------------------------------------

    def init_aux(self, root_states: State, prefix: tuple):
        """Prefill every slot's cache with its root prompt, once: the flat
        ``[N]`` pool prefills in ONE ragged batched forward
        (``prefill_ragged``)."""
        from ..models import init_cache, prefill_ragged

        prefix = tuple(int(p) for p in prefix)
        n = math.prod(prefix)
        lead = len(prefix) - 1

        def flat(x):
            x = x.unsqueeze(lead).expand(prefix + tuple(x.shape[lead:]))
            return x.reshape((n,) + tuple(x.shape[len(prefix):])).clone()

        state = map_state(flat, root_states)
        tokens = state.tokens.to(torch.int32)
        lengths = state.length.to(torch.int32)
        s_max = tokens.shape[-1]
        aux = {"tokens": tokens, "len": lengths, "pol": (), "rew": ()}
        for key, params, cfg in self._branches():
            logits, cache = prefill_ragged(
                params, cfg, tokens, lengths,
                init_cache(cfg, n, s_max, device=tokens.device))
            cache.pop("len")
            aux[key] = {"cache": cache, "logits": logits}
        return aux

    @staticmethod
    def _rollback_targets(sub, new_state, mask):
        """Per-row ``(start, target, tokens, common)`` for a refill rollback.

        ``common`` is the (uncapped) shared prefix of the cached tokens and
        the new path's; ``start`` caps it so the final prompt token is
        always re-decoded (the frontier evaluators compare against
        ``common`` to recognise rows whose forced re-decode would only
        regenerate logits their frontier snapshot holds).  Unmasked rows
        collapse to ``start == target == len`` (no-op).
        """
        s_max = sub["tokens"].shape[-1]
        pos = torch.arange(s_max, device=sub["tokens"].device)
        l_new = new_state.length.to(torch.int32)
        old_len = sub["len"]
        limit = torch.minimum(old_len, l_new)
        neq = (sub["tokens"] != new_state.tokens) & (pos[None, :] < limit[:, None])
        first = torch.where(neq, pos[None, :], s_max).amin(dim=1).to(torch.int32)
        common = torch.minimum(first, limit)
        start = torch.minimum(common, torch.clamp_min(l_new - 1, 0))
        start = torch.where(mask, start, old_len)
        target = torch.where(mask, l_new, old_len)
        tokens = torch.where(mask[:, None], new_state.tokens.to(sub["tokens"].dtype),
                             sub["tokens"])
        return start, target, tokens, common

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg
        hits = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        # Unmasked rows keep their cache unchanged, so a column that refills
        # no row costs one host sync and no copy.
        if not host_any(mask):
            return aux, hits
        sub = self._take_rows(aux, rows)
        start, target, tokens, _ = self._rollback_targets(sub, new_state, mask)
        sub["tokens"], sub["len"] = tokens, start
        sub = self._catch_up(sub, target)
        return self._put_rows(aux, rows, sub), hits

    def admit_aux(self, cfg, aux, rows, root_states, w):
        """Mid-stream admission, in place: one ragged prefill over the ``R``
        admitted roots (:func:`repro_torch.serving.admission.ragged_prefill`),
        fanned out to each row's ``w`` sibling slots along the cache's slot
        axis."""
        del cfg
        from ..models.lm import tree_map
        from ..serving.admission import ragged_prefill, splice_dense_slots

        flat = _flat_slot_rows(rows, w)
        tokens = root_states.tokens.to(torch.int32)
        lengths = root_states.length.to(torch.int32)
        aux["tokens"][flat] = tokens.repeat_interleave(w, dim=0)
        aux["len"][flat] = lengths.repeat_interleave(w, dim=0)
        for key, params, mcfg in self._branches():
            b = aux[key]
            logits, cache = ragged_prefill(params, mcfg, tokens, lengths,
                                           aux["tokens"].shape[-1])
            cache.pop("len")
            splice_dense_slots(b["cache"], flat,
                               tree_map(lambda x: x.repeat_interleave(w, dim=1), cache))
            b["logits"][flat] = logits.repeat_interleave(w, dim=0).to(b["logits"].dtype)
        return aux

    def init_ring_aux(self, cfg, proto_root_states, capacity: int):
        """Per-request staging for the request ring: one prefilled cache
        row and the root logits per staged request, spliced into all ``w``
        sibling slots at admission."""
        del cfg
        from ..models import init_cache

        c = int(capacity)
        s_max = proto_root_states.tokens.shape[-1]
        dev = proto_root_states.tokens.device
        ring = {"tokens": torch.zeros((c, s_max), dtype=torch.int32, device=dev),
                "len": torch.zeros((c,), dtype=torch.int32, device=dev), "pol": (), "rew": ()}
        for key, _, mcfg in self._branches():
            cache = init_cache(mcfg, c, s_max, device=dev)
            cache.pop("len")
            ring[key] = {"cache": cache, "logits": torch.zeros((c, mcfg.vocab_size),
                                                               dtype=torch.float32, device=dev)}
        return ring

    def stage_ring_aux(self, cfg, aux, ring_aux, slots, root_states):
        """Prefill the staged requests now, between segments, so that
        admission in the tick loop is a copy: ``admit_aux`` split at the
        prefill."""
        del cfg
        from ..models.lm import tree_map
        from ..serving.admission import ragged_prefill

        tokens = root_states.tokens.to(torch.int32)
        lengths = root_states.length.to(torch.int32)
        ring_aux["tokens"][slots] = tokens
        ring_aux["len"][slots] = lengths
        for key, params, mcfg in self._branches():
            rb = ring_aux[key]
            logits, cache = ragged_prefill(params, mcfg, tokens, lengths,
                                           ring_aux["tokens"].shape[-1])
            cache.pop("len")

            def put(buf, x):
                buf[:, slots] = x.to(buf.dtype)

            tree_map(put, rb["cache"], cache)
            rb["logits"][slots] = logits.to(rb["logits"].dtype)
        return aux, ring_aux

    def admit_aux_from_ring(self, cfg, aux, ring_aux, slot, rows, w):
        """In-loop admission: copy the staged rows ``slot`` into the ``w``
        sibling slots of tree rows ``rows`` (an index copy of those rows
        only)."""
        del cfg
        from ..models.lm import tree_map
        from ..serving.admission import splice_dense_slots

        flat = _flat_slot_rows(rows, w)
        src = slot.repeat_interleave(w)
        aux["tokens"][flat] = ring_aux["tokens"][src]
        aux["len"][flat] = ring_aux["len"][src]
        for key, _, _ in self._branches():
            b, rb = aux[key], ring_aux[key]
            splice_dense_slots(b["cache"], flat, tree_map(lambda x: x[:, src], rb["cache"]))
            b["logits"][flat] = rb["logits"][src].to(b["logits"].dtype)
        return aux, ring_aux

    def _catch_up(self, sub, target):
        """Re-decode each row's divergent suffix in batched ragged chunks:
        one ``decode_chunk`` advances every behind row by up to
        ``refill_chunk`` tokens at its own offset (one host sync per
        chunk)."""
        from ..models import decode_chunk

        s_max = sub["tokens"].shape[-1]
        c_sz = min(self.refill_chunk, s_max)
        offs = torch.arange(c_sz, device=target.device)
        while host_any(sub["len"] < target):
            base = sub["len"]
            behind = base < target
            gpos = torch.clamp_max(base[:, None].to(torch.int64) + offs[None, :], s_max - 1)
            toks = sub["tokens"].gather(1, gpos)
            new_len = base
            for key, params, cfg in self._branches():
                b = sub[key]
                logits, cache = decode_chunk(params, cfg, toks, target,
                                             dict(b["cache"], len=base))
                new_len = cache.pop("len")
                # Rows that finish inside this chunk got their final-position
                # logits from the gather; later chunks never touch them.
                fin = behind & (new_len >= target)
                sub[key] = {
                    "cache": cache,
                    "logits": torch.where(fin[:, None], logits, b["logits"]).to(b["logits"].dtype),
                }
            sub["len"] = new_len
        return sub

    def aux_len(self, aux) -> Optional[torch.Tensor]:
        return aux["len"]

    def aux_last_logits(self, aux) -> Optional[torch.Tensor]:
        return aux["pol"]["logits"]

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        if not isinstance(aux, dict):
            raise ValueError(
                "CachedModelEvaluator.tick needs its slot-aux cache (init_aux); it "
                "runs only inside the async engines — build with "
                "SearchSpec(engine='async') / build_searcher, or use ModelEvaluator "
                "for cache-free evaluation"
            )
        pol = aux["pol"]["logits"]
        rew = aux["rew"]["logits"] if isinstance(aux["rew"], dict) else pol
        out, token = self._transition(cfg, kind, act, state, rollout_done, acc, disc,
                                      steps, keys, pol, rew)
        # Exactly the slots whose env state appended a token this tick.
        fed = (kind != FREE) & ~state.done
        return out, self._advance(aux, token, fed)


# ---------------------------------------------------------------------------
# PagedCachedModelEvaluator — shared block pool + per-slot page tables.
# ---------------------------------------------------------------------------


class PagedCachedModelEvaluator(CachedModelEvaluator):
    """:class:`CachedModelEvaluator` over a paged KV layout
    (:mod:`repro_torch.models.paged`).

    Dense slot caches give each of the ``B·W`` slots a private ``[max_len]``
    row, although sibling slots share their root prompt and, after
    refills, long tree prefixes.  Here K/V live in a shared block pool
    addressed through per-slot page tables, so a shared prefix is stored
    once:

    * :meth:`init_aux` prefills each distinct root once (one ragged forward
      over the ``B`` roots), scatters its rows into pool pages and points
      the tables of all ``W`` sibling slots at them (refcount ``W``);
    * a slot about to write into a block with ``refcount > 1`` first copies
      it to a fresh private block (copy-on-write, :meth:`_page_write`);
    * :meth:`refill_aux` rolls back by a page-table edit: the suffix pages'
      refcounts fall back into the free pool
      (:func:`~repro_torch.models.release_pages`), and only the divergent
      suffix re-decodes.

    A tick's decode is ``models.paged_decode_step``, whose attention reads
    the pool through the tables (``paged_decode_attention``).  An
    allocation that finds the pool empty counts into ``aux['oom']``;
    :meth:`check_exhausted` (and ``init_aux``) raise it as
    :class:`~repro_torch.models.PagePoolExhaustedError`.

    Aux layout (flat slot axis ``N``; the pools are global):

    * ``tokens i32[N, S]`` / ``len i32[N]`` as the dense evaluator;
    * ``table i32[N, max_pages]``: pool block per logical page, garbage at
      page indices ``>= ceil(len / bs)``;
    * ``refcount i32[P]`` / ``oom i32[]``, shared by the branches (policy
      and reward model see the same tokens; each owns its pools);
    * ``pol``/``rew``: ``{"k", "v": [L, P, bs, Hkv, D], "logits": [N, V]}``.

    **In place:** as the dense evaluator, the hooks update the aux they
    are given; the pools are written in place (the reference's
    ``.at[].set`` with drop mode becomes :func:`put_where_`).

    **Split over data ranks** (:meth:`for_shard`): each rank's pool holds
    ``num_blocks // parts`` blocks for its own trees, its tables hold local
    block ids, and its ``oom`` is summed over the ranks before it is read,
    so every rank raises together.  Pages are shared only within a tree,
    and a tree never spans ranks, so copy-on-write stays rank-local.
    """

    _reduce_sum: Optional[Callable] = None

    def __init__(
        self,
        model_cfg,
        params,
        *,
        top_k: int,
        block_size: int,
        num_blocks: int,
        eos_token: int = 0,
        reward_cfg=None,
        reward_params=None,
        value_fn: Optional[Callable] = None,
    ):
        super().__init__(model_cfg, params, top_k=top_k, eos_token=eos_token,
                         reward_cfg=reward_cfg, reward_params=reward_params,
                         value_fn=value_fn)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.block_size = block_size
        self.num_blocks = num_blocks

    def for_shard(self, parts: int, reduce_sum: Callable) -> "PagedCachedModelEvaluator":
        """This evaluator over one data rank's pool of ``num_blocks //
        parts`` blocks; ``ValueError`` when ``parts`` does not divide
        ``num_blocks``."""
        if self.num_blocks % parts:
            raise ValueError(f"num_blocks={self.num_blocks} does not split over {parts} "
                             "data ranks: each rank's pool holds num_blocks // ranks blocks")
        ev = copy.copy(self)
        ev.num_blocks = self.num_blocks // parts
        ev._reduce_sum = reduce_sum
        return ev

    def _maybe_raise(self, oom: torch.Tensor) -> None:
        """Raise a latched pool-exhaustion count (one host sync), summed
        over the data ranks first when the pool is split."""
        from ..models import PagePoolExhaustedError

        where = ""
        if self._reduce_sum is not None:
            oom = self._reduce_sum(oom.reshape(1))[0]
            where = " in a data rank's share"
        if host_any(oom > 0):
            raise PagePoolExhaustedError(
                f"KV block pool exhausted{where}: {int(oom)} page allocation(s) failed "
                f"(num_blocks={self.num_blocks}, block_size={self.block_size}); grow "
                "num_blocks or reduce concurrent slots"
            )

    def check_exhausted(self, aux) -> None:
        """Raise :class:`~repro_torch.models.PagePoolExhaustedError` if any
        allocation failed since ``init_aux`` (call after a search).

        A pool split over data ranks is read through the evaluator of its
        share (:meth:`BatchedAsyncEngine.check_exhausted
        <repro_torch.core.batched_async_search.BatchedAsyncEngine.check_exhausted>`),
        which sums the count over the ranks: this evaluator, handed one
        rank's share, raises ``ValueError`` on every rank instead of
        reading that rank's count alone."""
        if aux["refcount"].shape[0] != self.num_blocks:
            raise ValueError(
                f"a pool of {aux['refcount'].shape[0]} blocks is one data rank's share of "
                f"num_blocks={self.num_blocks}: read it through "
                "BatchedAsyncEngine.check_exhausted(carry)")
        self._maybe_raise(aux["oom"])

    # -- aux structure helpers ---------------------------------------------

    @staticmethod
    def _take_rows(aux, rows):
        """Rows ``rows`` of the per-slot leaves (copies); the pools, the
        refcounts and ``oom`` are shared, not copied."""
        def branch(b):
            if not isinstance(b, dict):
                return ()
            return {"k": b["k"], "v": b["v"], "logits": b["logits"][rows]}

        return {"tokens": aux["tokens"][rows], "len": aux["len"][rows],
                "table": aux["table"][rows], "refcount": aux["refcount"],
                "oom": aux["oom"], "pol": branch(aux["pol"]), "rew": branch(aux["rew"])}

    @staticmethod
    def _put_rows(aux, rows, sub):
        """Write ``sub`` back into aux rows ``rows``, in place."""
        aux["tokens"][rows] = sub["tokens"]
        aux["len"][rows] = sub["len"]
        aux["table"][rows] = sub["table"]
        aux["refcount"], aux["oom"] = sub["refcount"], sub["oom"]
        for key in ("pol", "rew"):
            if isinstance(aux[key], dict):
                aux[key]["k"], aux[key]["v"] = sub[key]["k"], sub[key]["v"]
                aux[key]["logits"][rows] = sub[key]["logits"]
        return aux

    def _copy_blocks(self, branch, src, dst) -> None:
        """Copy-on-write: pool block ``src[i]`` to ``dst[i]`` in every layer
        where ``dst[i] < P``, in place (the reference's drop-mode copy)."""
        p = self.num_blocks
        src = torch.clamp(src.to(torch.int64), 0, p - 1)
        for name in ("k", "v"):
            pool = branch[name]
            put_where_(pool, (dst,), pool[:, src], dst < p, lead=1)

    def _page_write(self, table, refcount, oom, idx, pos, write):
        """Resolve where each ``write`` slot's K/V row for position ``pos``
        lands:

        * ``pos % bs == 0``: the slot enters a fresh page; allocate a block;
        * the page is started and shared (``refcount > 1``): copy-on-write,
          allocate, copy, and decref the shared block;
        * otherwise the slot owns the block and writes in place.

        Slots that do not write never touch the pool (target block ``P``).
        A failed allocation counts into ``oom`` and drops the write.
        ``table`` is updated in place.  Returns ``(table, refcount, oom,
        wb, off, copy_src, copy_dst)``: ``wb`` the write block per slot
        (``P``: no write), ``copy_src``/``copy_dst`` the copy-on-write
        blocks (``copy_dst == P``: no copy).
        """
        from ..models import alloc_blocks
        from ..models.paged import add_at

        bs = self.block_size
        p = refcount.shape[0]
        bi = (pos // bs).to(torch.int64)
        off = pos % bs
        cur = table[idx, bi]
        cur_c = torch.clamp(cur, 0, p - 1)
        started = off > 0
        shared = refcount[cur_c.to(torch.int64)] > 1
        need_new = write & (~started | shared)
        is_cow = write & started & shared
        blocks, refcount, n_fail = alloc_blocks(refcount, need_new)
        got = need_new & (blocks < p)
        oom = oom + n_fail
        refcount = add_at(refcount, cur_c, torch.full_like(cur_c, -1), is_cow & got)
        table[idx, bi] = torch.where(got, blocks, cur)
        ok = write & torch.where(need_new, got, True)
        wb = torch.where(ok, torch.clamp(table[idx, bi], 0, p - 1), p)
        copy_src = torch.where(is_cow & got, cur_c, 0)
        copy_dst = torch.where(is_cow & got, blocks, p)
        return table, refcount, oom, wb, off, copy_src, copy_dst

    def _advance(self, aux, token, fed):
        """Feed one token per slot: copy-on-write and allocation
        (:meth:`_page_write`), then one batched ``paged_decode_step`` per
        model; only ``fed`` slots write and commit."""
        from ..models import paged_decode_step

        length = aux["len"]
        idx, safe = self._write_tokens(aux, token, fed)
        table, refcount, oom, wb, off, copy_src, copy_dst = self._page_write(
            aux["table"], aux["refcount"], aux["oom"], idx, safe, fed)
        att_len = length + (wb < self.num_blocks).to(length.dtype)
        for key, params, cfg in self._branches():
            b = aux[key]
            self._copy_blocks(b, copy_src, copy_dst)
            logits, _ = paged_decode_step(params, cfg, token, {
                "k": b["k"], "v": b["v"], "table": table, "len": att_len, "pos": safe,
                "write_block": wb, "write_off": off})
            b["logits"] = torch.where(fed[:, None], logits, b["logits"]).to(b["logits"].dtype)
        aux.update(table=table, refcount=refcount, oom=oom,
                   len=torch.where(fed, length + 1, length))
        return aux

    # -- evaluator protocol -------------------------------------------------

    def init_aux(self, root_states: State, prefix: tuple):
        """Prefill each DISTINCT root once; its ``W = prefix[-1]`` sibling
        slots share its pages (refcount ``W``), the last partial page
        included: a slot's first write there copies it."""
        from ..models import init_cache, prefill_ragged
        from ..models.paged import add_at, num_pages

        prefix = tuple(int(q) for q in prefix)
        n = math.prod(prefix)
        w = prefix[-1]
        r0 = n // w
        lead = len(prefix) - 1

        def flat(x):
            x = x.unsqueeze(lead).expand(prefix + tuple(x.shape[lead:]))
            return x.reshape((n,) + tuple(x.shape[len(prefix):])).clone()

        state = map_state(flat, root_states)
        tokens = state.tokens.to(torch.int32)
        lengths = state.length.to(torch.int32)
        dev = tokens.device
        s_max = tokens.shape[-1]
        bs, p = self.block_size, self.num_blocks
        mp = num_pages(s_max, bs)

        root_tokens, root_len = tokens[::w], lengths[::w]
        p_r = (root_len + bs - 1) // bs                   # pages per root
        offsets = torch.cumsum(p_r, dim=0) - p_r          # sequential block ids
        page_idx = torch.arange(mp, device=dev)
        valid = page_idx[None, :] < p_r[:, None]
        dst_raw = offsets[:, None] + page_idx[None, :]
        got = valid & (dst_raw < p)
        dst = torch.where(got, dst_raw, p).to(torch.int32)   # [r0, mp]
        refcount = add_at(torch.zeros((p,), dtype=torch.int32, device=dev), dst,
                          torch.full_like(dst, w), got)
        aux = {"tokens": tokens, "len": lengths,
               "table": dst.repeat_interleave(w, dim=0), "refcount": refcount,
               "oom": (valid & ~got).sum().to(torch.int32), "pol": (), "rew": ()}
        for key, params, cfg in self._branches():
            logits, cache = prefill_ragged(params, cfg, root_tokens, root_len,
                                           init_cache(cfg, r0, mp * bs, device=dev))

            def to_pool(x):
                pages = x.reshape(x.shape[0], r0 * mp, bs, *x.shape[3:])
                pool = torch.zeros((x.shape[0], p, bs) + tuple(x.shape[3:]),
                                   dtype=x.dtype, device=dev)
                put_where_(pool, (dst.reshape(-1),), pages, got.reshape(-1), lead=1)
                return pool

            aux[key] = {"k": to_pool(cache["kv"]["k"]), "v": to_pool(cache["kv"]["v"]),
                        "logits": logits.repeat_interleave(w, dim=0)}
        self._maybe_raise(aux["oom"])
        return aux

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        """Rollback is a page-table edit; the catch-up re-decodes the
        divergent suffix in batched ragged chunks (:meth:`_paged_catch_up`).

        Suffix pages wholly past the common prefix are released; the kept
        partial boundary page may still be shared, so the first catch-up
        write into it copies it.
        """
        del cfg
        from ..models import release_pages

        hits = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        if not host_any(mask):
            return aux, hits
        sub = self._take_rows(aux, rows)
        start, target, tokens, _ = self._rollback_targets(sub, new_state, mask)
        bs = self.block_size
        lo = (start + bs - 1) // bs
        hi = (sub["len"] + bs - 1) // bs
        sub["refcount"] = release_pages(sub["refcount"], sub["table"], lo, hi)
        sub["tokens"], sub["len"] = tokens, start
        sub = self._paged_catch_up(sub, target)
        return self._put_rows(aux, rows, sub), hits

    def _paged_catch_up(self, sub, target):
        """Chunked divergent-suffix re-decode over paged rows.

        Every page the suffix will write is resolved first (copy-on-write
        of a shared boundary page, then one fresh block per whole suffix
        page), so all written pages are private.  The catch-up then runs
        the dense evaluator's batched ``decode_chunk`` loop over a dense
        gather of the rows' pages, and the written pages are scattered
        back; pages whose allocation failed are left out (shared blocks are
        never written) and the failure counts into ``oom``.
        ``sub['len']`` holds each row's re-decode start.  Skipped, after
        one host sync, when no row is behind.
        """
        if not host_any(sub["len"] < target):
            return sub
        return self._paged_catch_up_behind(sub, target)

    def _paged_catch_up_behind(self, sub, target):
        from ..models import alloc_blocks

        bs, p = self.block_size, self.num_blocks
        r, mp = sub["table"].shape
        s_max = sub["tokens"].shape[-1]
        dev = target.device
        idx = torch.arange(r, device=dev)
        start = sub["len"]
        behind = start < target

        # Boundary page: rows resuming mid-page copy shared blocks first.
        bwrite = behind & (start % bs > 0)
        table, refcount, oom, wb, _, copy_src, copy_dst = self._page_write(
            sub["table"], sub["refcount"], sub["oom"], idx,
            torch.clamp_max(start, s_max - 1), bwrite)
        page_ok = torch.ones((r, mp), dtype=torch.bool, device=dev)
        page_ok[idx, torch.clamp(start // bs, 0, mp - 1).to(torch.int64)] = torch.where(
            bwrite, wb < p, True)
        for key, _, _ in self._branches():
            self._copy_blocks(sub[key], copy_src, copy_dst)

        # The whole suffix's schedule: one fresh block per page in [lo, hi).
        lo = (start + bs - 1) // bs
        hi = (target + bs - 1) // bs
        for pi in range(mp):
            need = behind & (pi >= lo) & (pi < hi)
            blocks, refcount, n_fail = alloc_blocks(refcount, need)
            got = need & (blocks < p)
            table[:, pi] = torch.where(got, blocks, table[:, pi])
            page_ok[:, pi] = torch.where(need, got, page_ok[:, pi])
            oom = oom + n_fail

        # Dense view -> the dense evaluator's chunked catch-up -> scatter back.
        t_clip = torch.clamp(table, 0, p - 1).to(torch.int64)

        def dense(pool):
            out = pool[:, t_clip]                          # [L, R, mp, bs, Hkv, D]
            return out.reshape(out.shape[0], r, mp * bs, *out.shape[4:])

        dsub = {"tokens": sub["tokens"], "len": sub["len"], "pol": (), "rew": ()}
        for key, _, _ in self._branches():
            b = sub[key]
            dsub[key] = {"cache": {"kv": {"k": dense(b["k"]), "v": dense(b["v"])}},
                         "logits": b["logits"]}
        dsub = self._catch_up(dsub, target)

        pages = torch.arange(mp, device=dev)
        changed = (behind[:, None] & (pages[None, :] >= (start // bs)[:, None])
                   & (pages[None, :] < hi[:, None]) & page_ok).reshape(-1)
        dst = torch.where(changed, t_clip.reshape(-1), p)
        for key, _, _ in self._branches():
            kv = dsub[key]["cache"]["kv"]
            for name in ("k", "v"):
                x = kv[name]
                put_where_(sub[key][name], (dst,),
                           x.reshape(x.shape[0], r * mp, bs, *x.shape[3:]), changed, lead=1)
            sub[key]["logits"] = dsub[key]["logits"]
        sub.update(table=table, refcount=refcount, oom=oom, len=dsub["len"])
        return sub

    def admit_aux(self, cfg, aux, rows, root_states, w):
        """Mid-stream admission, in place: page release, re-prefill, table
        splice.

        The rows' slots first return what they still hold to the pool (an
        evicted row's ``len`` is 0, so nothing is released twice).  Each
        admitted root then prefills once, its rows scatter into freshly
        allocated pool pages
        (:func:`repro_torch.serving.admission.splice_pool_pages`), and the
        ``w`` sibling slots' tables point at the same pages with refcount
        ``w``, the layout ``init_aux`` builds.  Exhaustion raises
        :class:`~repro_torch.models.PagePoolExhaustedError`; a data rank's
        share only latches it, since the other ranks admit no rows of it:
        the engine then reads it on every rank
        (``BatchedAsyncEngine.check_exhausted``).
        """
        del cfg
        from ..models import release_pages
        from ..models.paged import add_at
        from ..serving.admission import ragged_prefill, splice_pool_pages

        flat = _flat_slot_rows(rows, w)
        tokens = root_states.tokens.to(torch.int32)
        lengths = root_states.length.to(torch.int32)
        bs, p = self.block_size, self.num_blocks
        mp = aux["table"].shape[1]
        hi = (aux["len"][flat] + bs - 1) // bs
        refcount = release_pages(aux["refcount"], aux["table"][flat], torch.zeros_like(hi), hi)

        # One block per root page (refcount 1 from alloc_blocks), then the
        # other w - 1 sharers.
        dst, refcount, oom = self._alloc_prompt_pages(refcount, aux["oom"], lengths, mp)
        refcount = add_at(refcount, dst, torch.full_like(dst, w - 1), dst < p)

        aux["tokens"][flat] = tokens.repeat_interleave(w, dim=0)
        aux["len"][flat] = lengths.repeat_interleave(w, dim=0)
        aux["table"][flat] = dst.repeat_interleave(w, dim=0)
        aux.update(refcount=refcount, oom=oom)
        for key, params, mcfg in self._branches():
            b = aux[key]
            logits, cache = ragged_prefill(params, mcfg, tokens, lengths, mp * bs)
            splice_pool_pages(b["k"], b["v"], cache["kv"]["k"], cache["kv"]["v"], dst)
            b["logits"][flat] = logits.repeat_interleave(w, dim=0).to(b["logits"].dtype)
        if self._reduce_sum is None:
            self._maybe_raise(aux["oom"])
        return aux

    def _alloc_prompt_pages(self, refcount, oom, lengths, mp: int):
        """One fresh block (refcount 1) per page of each prompt of
        ``lengths``: ``(dst i32[R, mp], refcount, oom)``, ``dst`` the block
        per logical page (the sentinel ``P`` past a prompt's pages or where
        the pool ran out; failures count into ``oom``)."""
        from ..models import alloc_blocks

        p = self.num_blocks
        p_r = (lengths + self.block_size - 1) // self.block_size
        dst = torch.full((lengths.shape[0], mp), p, dtype=torch.int32, device=lengths.device)
        for pi in range(mp):
            need = pi < p_r
            blocks, refcount, n_fail = alloc_blocks(refcount, need)
            dst[:, pi] = torch.where(need & (blocks < p), blocks, p)
            oom = oom + n_fail
        return dst, refcount, oom

    def init_ring_aux(self, cfg, proto_root_states, capacity: int):
        """Ring staging of the paged evaluator: tokens, a page table and the
        root logits per staged request.  The K/V themselves are not staged:
        a staged request's pages already live in the shared pool (written
        by :meth:`stage_ring_aux`, held at refcount 1 by the ring), so
        admission is a table splice and a refcount fan-out."""
        del cfg
        from ..models.paged import num_pages

        c = int(capacity)
        s_max = proto_root_states.tokens.shape[-1]
        dev = proto_root_states.tokens.device
        ring = {"tokens": torch.zeros((c, s_max), dtype=torch.int32, device=dev),
                "len": torch.zeros((c,), dtype=torch.int32, device=dev),
                "table": torch.full((c, num_pages(s_max, self.block_size)), self.num_blocks,
                                    dtype=torch.int32, device=dev),
                "pol": (), "rew": ()}
        for key, _, mcfg in self._branches():
            ring[key] = {"logits": torch.zeros((c, mcfg.vocab_size), dtype=torch.float32,
                                               device=dev)}
        return ring

    def stage_ring_aux(self, cfg, aux, ring_aux, slots, root_states):
        """Allocate and prefill the staged requests' pool pages now.

        The pages come from the live refcounts (the service budgets against
        them before staging), are written by one ragged prefill and stay at
        refcount 1, owned by the ring, until admission hands them to a row.
        Exhaustion latches ``oom`` (the caller raises it after the segment);
        ring slots outside the staged window hold no pages (admission clears
        them), so nothing is released here.
        """
        del cfg
        from ..serving.admission import ragged_prefill, splice_pool_pages

        tokens = root_states.tokens.to(torch.int32)
        lengths = root_states.length.to(torch.int32)
        mp = ring_aux["table"].shape[1]
        dst, refcount, oom = self._alloc_prompt_pages(aux["refcount"], aux["oom"], lengths, mp)
        ring_aux["tokens"][slots] = tokens
        ring_aux["len"][slots] = lengths
        ring_aux["table"][slots] = dst
        aux.update(refcount=refcount, oom=oom)
        for key, params, mcfg in self._branches():
            b = aux[key]
            logits, cache = ragged_prefill(params, mcfg, tokens, lengths, mp * self.block_size)
            splice_pool_pages(b["k"], b["v"], cache["kv"]["k"], cache["kv"]["v"], dst)
            ring_aux[key]["logits"][slots] = logits.to(ring_aux[key]["logits"].dtype)
        return aux, ring_aux

    def admit_aux_from_ring(self, cfg, aux, ring_aux, slot, rows, w):
        """In-loop paged admission: a table splice and a refcount fan-out.

        The target rows were evicted first (the round harvests before it
        admits), so nothing is released.  The ring's one reference to each
        page passes to the first sibling slot and the fan-out adds the other
        ``w - 1``, the layout :meth:`admit_aux` builds; the consumed ring
        slots drop to the sentinel, so no page is released twice.
        """
        del cfg
        from ..models.paged import add_at

        flat = _flat_slot_rows(rows, w)
        src = slot.repeat_interleave(w)
        p = self.num_blocks
        dst = ring_aux["table"][slot]                                 # [R, mp]
        aux["refcount"] = add_at(aux["refcount"], dst, torch.full_like(dst, w - 1), dst < p)
        aux["tokens"][flat] = ring_aux["tokens"][src]
        aux["len"][flat] = ring_aux["len"][src]
        aux["table"][flat] = ring_aux["table"][src]
        for key, _, _ in self._branches():
            b = aux[key]
            b["logits"][flat] = ring_aux[key]["logits"][src].to(b["logits"].dtype)
        ring_aux["table"][slot] = p
        ring_aux["len"][slot] = 0
        return aux, ring_aux

    def evict_aux(self, aux, rows, w):
        """Return settled rows' pages to the pool, in place: tables drop to
        the sentinel and ``len`` to 0, so the rows' frozen FREE slots never
        read a released block and a later :meth:`admit_aux` releases
        nothing twice."""
        from ..models import release_pages

        flat = _flat_slot_rows(rows, w)
        bs = self.block_size
        hi = (aux["len"][flat] + bs - 1) // bs
        aux["refcount"] = release_pages(aux["refcount"], aux["table"][flat],
                                        torch.zeros_like(hi), hi)
        aux["table"][flat] = self.num_blocks
        aux["len"][flat] = 0
        return aux

    def aux_blocks(self, aux) -> torch.Tensor:
        """Number of pool blocks in use (refcount > 0)."""
        return (aux["refcount"] > 0).sum()


# ---------------------------------------------------------------------------
# Frontier-speculative expansion: score every candidate child in one forward.
# ---------------------------------------------------------------------------


class _FrontierMixin:
    """Frontier-cache logic shared by the dense and the paged evaluator.

    An EXPAND tick runs ``models.decode_frontier`` / ``paged_decode_frontier``:
    instead of decoding only the chosen token, the slot's ``A = top_k``
    candidate children (the top-K table :meth:`ModelEvaluator._transition`
    decodes ranks against) are scored in one tree-batched forward over the
    shared prefix.  The chosen candidate's logits and K/V row commit to the
    cache, as the plain decode step would have; EXPAND rows also snapshot
    the whole frontier in ``aux['fr']``:

    * ``ptok``/``plen``: the parent path the frontier was scored from;
    * ``cand [N, A]``: the candidate tokens;
    * per branch ``plog`` (the parent's logits), ``clog [N, A, V]`` (every
      candidate's next-position logits) and ``ck``/``cv [L, N, A, Hkv, D]``
      (every candidate's own K/V entry).

    **Refill hits** (``refill_aux`` of the concrete classes): WU-UCT's
    refill mostly hands a settled slot the same parent again (a sibling
    expansion) or one of its children, which the snapshot answers:

    * *parent hit* (the path is ``ptok`` and ``len == plen``): restore
      ``plog`` and set ``len`` to the target;
    * *child hit* (``len == plen + 1``, last token in ``cand``): restore
      ``clog[rank]`` and commit ``ck``/``cv[rank]`` at position ``plen``.

    Hit rows skip the catch-up (no forward), and the returned ``hits``
    mask feeds the engine's per-tree frontier-hit counter.  A refill onto a
    path that diverges from ``ptok`` invalidates the entry.  Ticks with no
    EXPAND row take the plain one-token advance (one host sync decides).
    """

    def _fr_init(self, aux):
        n = aux["tokens"].shape[0]
        a = self.top_k
        dev = aux["tokens"].device
        fr = {"ptok": torch.zeros_like(aux["tokens"]),
              "plen": torch.zeros((n,), dtype=torch.int32, device=dev),
              "valid": torch.zeros((n,), dtype=torch.bool, device=dev),
              "cand": torch.zeros((n, a), dtype=torch.int64, device=dev),
              "pol": (), "rew": ()}
        for key, _, cfg in self._branches():
            lg = aux[key]["logits"]
            spec = (cfg.num_layers, n, a, cfg.num_kv_heads, cfg.head_dim)
            fr[key] = {"plog": torch.zeros_like(lg),
                       "clog": torch.zeros((n, a, lg.shape[-1]), dtype=lg.dtype, device=dev),
                       "ck": torch.zeros(spec, dtype=cfg.dtype, device=dev),
                       "cv": torch.zeros(spec, dtype=cfg.dtype, device=dev)}
        return fr

    def init_aux(self, root_states, prefix):
        aux = super().init_aux(root_states, prefix)
        aux["fr"] = self._fr_init(aux)
        return aux

    def _take_rows(self, aux, rows):
        sub = super()._take_rows(aux, rows)
        fr = aux["fr"]

        def branch(b):
            if not isinstance(b, dict):
                return ()
            return {"plog": b["plog"][rows], "clog": b["clog"][rows],
                    "ck": b["ck"][:, rows], "cv": b["cv"][:, rows]}

        sub["fr"] = {"ptok": fr["ptok"][rows], "plen": fr["plen"][rows],
                     "valid": fr["valid"][rows], "cand": fr["cand"][rows],
                     "pol": branch(fr["pol"]), "rew": branch(fr["rew"])}
        return sub

    def _put_rows(self, aux, rows, sub):
        aux = super()._put_rows(aux, rows, sub)
        fr, sfr = aux["fr"], sub["fr"]
        for name in ("ptok", "plen", "valid", "cand"):
            fr[name][rows] = sfr[name]
        for key in ("pol", "rew"):
            if isinstance(fr[key], dict):
                for name in ("plog", "clog"):
                    fr[key][name][rows] = sfr[key][name]
                for name in ("ck", "cv"):
                    fr[key][name][:, rows] = sfr[key][name]
        return aux

    def admit_aux(self, cfg, aux, rows, root_states, w):
        """Admission invalidates the rows' frontier snapshots: they were
        taken in the previous request's tree."""
        aux = super().admit_aux(cfg, aux, rows, root_states, w)
        aux["fr"]["valid"][_flat_slot_rows(rows, w)] = False
        return aux

    def evict_aux(self, aux, rows, w):
        aux = super().evict_aux(aux, rows, w)
        aux["fr"]["valid"][_flat_slot_rows(rows, w)] = False
        return aux

    def admit_aux_from_ring(self, cfg, aux, ring_aux, slot, rows, w):
        """In-loop admission invalidates the rows' snapshots too; a frontier
        snapshot is per slot, not per request, so staging has nothing to
        add."""
        aux, ring_aux = super().admit_aux_from_ring(cfg, aux, ring_aux, slot, rows, w)
        aux["fr"]["valid"][_flat_slot_rows(rows, w)] = False
        return aux, ring_aux

    @staticmethod
    def _fr_record(fr, pre_tokens, length, cand, is_exp):
        """Snapshot the parent path and the candidate set on EXPAND rows."""
        exp2 = is_exp[:, None]
        return dict(fr, ptok=torch.where(exp2, pre_tokens, fr["ptok"]),
                    plen=torch.where(is_exp, length, fr["plen"]),
                    valid=fr["valid"] | is_exp,
                    cand=torch.where(exp2, cand, fr["cand"]))

    @staticmethod
    def _fr_snapshot(fb, logits, clog, spec, is_exp):
        """The branch snapshot after a frontier forward: ``logits`` (the
        parent's), ``clog`` and ``spec`` replace the old where ``is_exp``."""
        e5 = is_exp[None, :, None, None, None]
        return {"plog": torch.where(is_exp[:, None], logits, fb["plog"]),
                "clog": torch.where(is_exp[:, None, None], clog, fb["clog"]).to(fb["clog"].dtype),
                "ck": torch.where(e5, spec["k"], fb["ck"]).to(fb["ck"].dtype),
                "cv": torch.where(e5, spec["v"], fb["cv"]).to(fb["cv"].dtype)}

    def _frontier_hits(self, sub, tokens, new_state, common, mask):
        """Classify each refill row against its snapshot: ``(parent_hit,
        child_hit, crank, pmatch)``, ``crank`` the matched candidate's rank
        (meaningful under ``child_hit``).  Both kinds need the cache to
        still hold the parent prefix (the uncapped ``common``) and the new
        path to match the snapshot's parent path (``pmatch``)."""
        fr = sub["fr"]
        r, s_max = tokens.shape
        dev = tokens.device
        idx = torch.arange(r, device=dev)
        pos = torch.arange(s_max, device=dev)
        l_new = new_state.length.to(torch.int32)
        plen = fr["plen"]
        cmp_len = torch.minimum(plen, l_new)
        pmatch = ~((fr["ptok"] != tokens) & (pos[None, :] < cmp_len[:, None])).any(dim=1)
        last = tokens[idx, torch.clamp(l_new - 1, 0, s_max - 1)]
        is_cand = fr["cand"] == last[:, None].to(fr["cand"].dtype)
        # First matching rank (argmax over an integer cast: the first
        # maximum wins, as jnp.argmax over booleans).
        crank = torch.argmax(is_cand.to(torch.int32), dim=1)
        ok = mask & fr["valid"] & pmatch
        parent_hit = ok & (l_new == plen) & (common >= l_new)
        child_hit = ok & (l_new == plen + 1) & is_cand.any(dim=1) & (common >= plen)
        return parent_hit, child_hit, crank, pmatch

    def _candidates(self, aux, token):
        """The top-K table the transition decoded ``token`` against, and
        the fed token's rank in it (it is always one of the candidates)."""
        from ..envs.token_env import sorted_top_k

        _, cand = sorted_top_k(aux["pol"]["logits"], self.top_k)
        rank = torch.argmax((cand == token[:, None]).to(torch.int32), dim=1)
        return cand, rank

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        if not isinstance(aux, dict):
            raise ValueError(
                "frontier evaluators need their slot-aux cache (init_aux); they run "
                "only inside the async engines — build with SearchSpec(engine='async') "
                "/ build_searcher"
            )
        pol = aux["pol"]["logits"]
        rew = aux["rew"]["logits"] if isinstance(aux["rew"], dict) else pol
        out, token = self._transition(cfg, kind, act, state, rollout_done, acc, disc,
                                      steps, keys, pol, rew)
        fed = (kind != FREE) & ~state.done
        is_exp = fed & (kind == EXPAND)
        # Only EXPAND rows need the A-wide snapshot; most ticks are
        # mid-rollout and take the one-token advance (the reference's
        # lax.cond, here one host sync).
        if host_any(is_exp):
            return out, self._advance_frontier(aux, token, fed, is_exp)
        return out, self._advance(aux, token, fed)


class FrontierModelEvaluator(_FrontierMixin, CachedModelEvaluator):
    """:class:`CachedModelEvaluator` with frontier-speculative expansion.

    EXPAND ticks run ``models.decode_frontier`` (tree-batched candidate
    scoring over the dense per-slot cache, ``tree_decode_attention``);
    refills of the snapshot parent or of one of its candidate children are
    answered from aux with no forward.  See :class:`_FrontierMixin`.
    """

    def _advance_frontier(self, aux, token, fed, is_exp):
        """One tree-batched frontier forward advances every slot: the
        chosen candidate's logits and K/V row commit (in place) as
        :meth:`CachedModelEvaluator._advance` would have; EXPAND rows
        snapshot the whole candidate set."""
        from ..models import decode_frontier

        length = aux["len"]
        pre_tokens = aux["tokens"].clone()
        idx, safe = self._write_tokens(aux, token, fed)
        cand, rank = self._candidates(aux, token)
        fr = self._fr_record(aux["fr"], pre_tokens, length, cand, is_exp)
        for key, params, cfg in self._branches():
            b = aux[key]
            clog, spec = decode_frontier(params, cfg, cand, dict(b["cache"], len=safe))
            kv = b["cache"]["kv"]
            kv["k"][:, idx, safe] = spec["k"][:, idx, rank].to(kv["k"].dtype)
            kv["v"][:, idx, safe] = spec["v"][:, idx, rank].to(kv["v"].dtype)
            fr[key] = self._fr_snapshot(fr[key], b["logits"], clog, spec, is_exp)
            b["logits"] = torch.where(fed[:, None], clog[idx, rank],
                                      b["logits"]).to(b["logits"].dtype)
        aux["len"] = torch.where(fed, length + 1, length)
        aux["fr"] = fr
        return aux

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg
        hits = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        if not host_any(mask):
            return aux, hits
        sub = self._take_rows(aux, rows)
        s_max = sub["tokens"].shape[-1]
        idx = torch.arange(rows.shape[0], device=rows.device)
        start, target, tokens, common = self._rollback_targets(sub, new_state, mask)
        parent_hit, child_hit, crank, pmatch = self._frontier_hits(
            sub, tokens, new_state, common, mask)
        hit = parent_hit | child_hit
        fr = sub["fr"]
        sub["tokens"], sub["len"] = tokens, torch.where(hit, target, start)
        cpos = torch.clamp(fr["plen"], 0, s_max - 1)
        for key, _, _ in self._branches():
            b, fb = sub[key], fr[key]
            logits = torch.where(parent_hit[:, None], fb["plog"], b["logits"])
            b["logits"] = torch.where(child_hit[:, None], fb["clog"][idx, crank],
                                      logits).to(b["logits"].dtype)
            kv = b["cache"]["kv"]
            ch = child_hit[None, :, None, None]
            for name, spec in (("k", fb["ck"]), ("v", fb["cv"])):
                kv[name][:, idx, cpos] = torch.where(ch, spec[:, idx, crank],
                                                     kv[name][:, idx, cpos])
        fr["valid"] = torch.where(mask, fr["valid"] & pmatch, fr["valid"])
        sub = self._catch_up(sub, target)
        return self._put_rows(aux, rows, sub), hit


class PagedFrontierModelEvaluator(_FrontierMixin, PagedCachedModelEvaluator):
    """:class:`PagedCachedModelEvaluator` with frontier-speculative
    expansion: candidate scoring reads the prefix straight from the pages
    (``models.paged_decode_frontier``, ``paged_tree_decode_attention``; no
    dense gather), and a child hit commits its snapshot K/V row through the
    usual page bookkeeping (:meth:`_page_write`)."""

    def _advance_frontier(self, aux, token, fed, is_exp):
        """The frontier forward over the page tables; the chosen row
        commits through copy-on-write and allocation."""
        from ..models import paged_decode_frontier

        length = aux["len"]
        pre_tokens = aux["tokens"].clone()
        idx, safe = self._write_tokens(aux, token, fed)
        table, refcount, oom, wb, off, copy_src, copy_dst = self._page_write(
            aux["table"], aux["refcount"], aux["oom"], idx, safe, fed)
        writes = wb < self.num_blocks
        cand, rank = self._candidates(aux, token)
        fr = self._fr_record(aux["fr"], pre_tokens, length, cand, is_exp)
        for key, params, cfg in self._branches():
            b = aux[key]
            self._copy_blocks(b, copy_src, copy_dst)
            clog, spec = paged_decode_frontier(params, cfg, cand, {
                "k": b["k"], "v": b["v"], "table": table, "len": safe})
            for name in ("k", "v"):
                put_where_(b[name], (wb, off), spec[name][:, idx, rank].to(b[name].dtype),
                           writes, lead=1)
            fr[key] = self._fr_snapshot(fr[key], b["logits"], clog, spec, is_exp)
            b["logits"] = torch.where(fed[:, None], clog[idx, rank],
                                      b["logits"]).to(b["logits"].dtype)
        aux.update(table=table, refcount=refcount, oom=oom,
                   len=torch.where(fed, length + 1, length), fr=fr)
        return aux

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg
        from ..models import release_pages

        hits = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        if not host_any(mask):
            return aux, hits
        sub = self._take_rows(aux, rows)
        s_max = sub["tokens"].shape[-1]
        idx = torch.arange(rows.shape[0], device=rows.device)
        start, target, tokens, common = self._rollback_targets(sub, new_state, mask)
        parent_hit, child_hit, crank, pmatch = self._frontier_hits(
            sub, tokens, new_state, common, mask)
        fr = sub["fr"]
        plen = fr["plen"]
        bs = self.block_size

        # Hit-aware release: a parent hit keeps the whole target prefix, a
        # child hit the parent prefix (its commit lands at plen).
        keep = torch.where(parent_hit, target, torch.where(child_hit, plen, start))
        refcount = release_pages(sub["refcount"], sub["table"], (keep + bs - 1) // bs,
                                 (sub["len"] + bs - 1) // bs)
        # The child-hit commit, through the page bookkeeping; a failed
        # allocation demotes the row to a miss.
        cpos = torch.clamp(plen, 0, s_max - 1)
        table, refcount, oom, wb, off, copy_src, copy_dst = self._page_write(
            sub["table"], refcount, sub["oom"], idx, cpos, child_hit)
        writes = wb < self.num_blocks
        committed = child_hit & writes
        hit = parent_hit | committed
        sub.update(table=table, refcount=refcount, oom=oom, tokens=tokens,
                   len=torch.where(hit, target, start))
        for key, _, _ in self._branches():
            b, fb = sub[key], fr[key]
            self._copy_blocks(b, copy_src, copy_dst)
            for name, spec in (("k", fb["ck"]), ("v", fb["cv"])):
                put_where_(b[name], (wb, off), spec[:, idx, crank], writes, lead=1)
            logits = torch.where(parent_hit[:, None], fb["plog"], b["logits"])
            b["logits"] = torch.where(committed[:, None], fb["clog"][idx, crank],
                                      logits).to(b["logits"].dtype)
        fr["valid"] = torch.where(mask, fr["valid"] & pmatch, fr["valid"])
        sub = self._paged_catch_up(sub, target)
        return self._put_rows(aux, rows, sub), hit
