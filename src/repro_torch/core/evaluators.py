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

Three evaluators: :class:`RolloutEvaluator` (``env.policy`` rollouts),
:class:`ModelEvaluator` (one batched LM ``forward`` per tick over the token
environment) and :class:`CachedModelEvaluator` (one batched
``decode_step`` per tick against per-slot KV caches).  The serving hooks
(``admit_aux``, ``evict_aux``, the ring hooks) come with serving, the
paged and frontier evaluators with their kernels.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state, where_state
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
      holds; returns ``(aux, hits)``, ``hits`` all false (no frontier
      cache in the port yet);
    * ``aux_len(aux)`` / ``aux_last_logits(aux)``: per-slot cache depth and
      last logits, ``None`` where the evaluator keeps none.
    """

    env: Optional[Environment] = None

    def init_aux(self, root_states: State, prefix: tuple):
        del root_states, prefix
        return ()

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg, new_state, mask
        return aux, torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)

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
    the slot's key, as the reference draws it; the port draws the Gumbel
    noise in float32, which is the reference's draw for float32 models (a
    bfloat16 reference model draws it in bfloat16).
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
        ranks = rng.categorical(keys, top_vals.float())
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

        idx = torch.arange(token.shape[0], device=token.device)
        s_max = aux["tokens"].shape[-1]
        length = aux["len"]
        safe = torch.clamp_max(length, s_max - 1)
        prev = aux["tokens"][idx, safe]
        aux["tokens"][idx, safe] = torch.where(fed, token.to(prev.dtype), prev)
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
        """Per-row ``(start, target, tokens)`` for a refill rollback.

        ``start`` is the shared prefix of the cached tokens and the new
        path's, capped so the final prompt token is always re-decoded;
        unmasked rows collapse to ``start == target == len`` (no-op).
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
        return start, target, tokens

    def refill_aux(self, cfg, aux, rows, new_state, mask):
        del cfg
        hits = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        # Unmasked rows keep their cache unchanged, so a column that refills
        # no row costs one host sync and no copy.
        if not host_any(mask):
            return aux, hits
        sub = self._take_rows(aux, rows)
        start, target, tokens = self._rollback_targets(sub, new_state, mask)
        sub["tokens"], sub["len"] = tokens, start
        sub = self._catch_up(sub, target)
        return self._put_rows(aux, rows, sub), hits

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
