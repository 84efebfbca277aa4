"""Batched async-slot WU-UCT: ``B`` independent async searches in lockstep
(counterpart of ``repro.core.batched_async_search``).

The engine that reproduces the paper's master–worker interleaving:
rollouts settle at different ticks and a freed slot is refilled at once.
``B`` trees × ``W`` async slots advance one master tick at a time:

* **refill** fills each tree's FREE slots, slot ``j`` of all ``B`` trees
  together, each column's traversal one launch of the ``tree_descend``
  kernel (:func:`~repro_torch.core.batched_search.traverse_batched`); the
  evaluator's slot caches re-sync through ``refill_aux``;
* **tick** advances every busy slot by one environment step as one flat
  ``[B·W]`` batch — with a model evaluator, one batched model call per
  master tick;
* **settle** finalizes expanded children and completes finished rollouts,
  with per-tree masks (settles land at different ticks per tree).

Random streams are split per tree exactly as the reference splits them,
so with the same keys this engine makes the reference's decisions.  Trees
and slots are updated **in place** (:mod:`repro_torch.core.batched_tree`).

Host syncs (:data:`repro_torch.sync.SYNCS`): one per master tick for the
loop condition, one per slot column for "does any tree refill here", the
path walks' per-level syncs for the columns that do (and, on the CPU, the
traversal's), and the evaluator's own (the cached evaluators' catch-up
loops, the frontier evaluators' "any EXPAND row" per tick).

The carry counts, per tree, the refills a frontier evaluator answered from
its snapshot (:meth:`BatchedAsyncEngine.frontier_hits`).

Trace mode (``run(..., trace_ticks=K)``) runs exactly ``K`` ticks and
snapshots each (:class:`~repro_torch.core.async_search.AsyncTickTrace`).
Host-paced serving rests on :meth:`BatchedAsyncEngine.admit` and
:meth:`~BatchedAsyncEngine.evict`; the reference's device-resident request
ring (``serve_segment``) is not ported yet (ROADMAP.md §1, item 4).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..envs.base import Environment, map_state
from ..sync import host_any
from . import batched_tree as btree
from .batched_search import (
    _expansion_actions,
    _mark_in_flight,
    _settle,
    _split_each,
    traverse_batched,
)
from .batched_tree import init_batched_tree
from .evaluators import EXPAND, FREE, SIM, Evaluator, RolloutEvaluator
from .wu_uct import SearchConfig, SearchResult

State = Any


class _BatchedAsyncSlots(NamedTuple):
    kind: torch.Tensor          # i64[B, W]  FREE / EXPAND / SIM
    sim_node: torch.Tensor      # i64[B, W]  node being evaluated
    act: torch.Tensor           # i64[B, W]  expansion action (EXPAND phase)
    state: State                # [B, W, ...] current rollout env state
    rollout_done: torch.Tensor  # bool[B, W]
    acc: torch.Tensor           # f32[B, W]  discounted return accumulator
    disc: torch.Tensor          # f32[B, W]
    steps: torch.Tensor         # i32[B, W]  simulation steps taken


# The loop carry, the reference's: (tree, slots, rng[B, 2], t_launch[B],
# t_done[B], ticks[B], max_o[B], aux, frontier_hits[B]).
Carry = tuple


class BatchedAsyncEngine:
    """``B``-tree async-slot WU-UCT.

    * :meth:`init_carry` builds the loop carry;
    * :meth:`step` / :meth:`run_segment` run one / up to ``n`` master
      ticks with settled trees frozen;
    * :meth:`alive` / :meth:`settled` say which trees still search;
    * :meth:`result` is the ``SearchResult[B]`` snapshot, and
      :meth:`frontier_hits` the per-tree count of refills a frontier
      evaluator answered without a forward;
    * :meth:`run` does all of it for one batch of roots.
    """

    def __init__(self, env: Environment, cfg: SearchConfig, batch: int, *,
                 evaluator: Optional[Evaluator] = None):
        self.env = env
        self.cfg = cfg
        self.B = int(batch)
        self.W = cfg.wave_size
        self.T = cfg.num_simulations
        self.width = min(cfg.max_width, env.num_actions)
        self.capacity = cfg.num_simulations + cfg.wave_size + 1
        self.evaluator = evaluator if evaluator is not None else RolloutEvaluator(env)
        # The single async engine ignores deterministic_expansion.
        self._exp_cfg = cfg._replace(deterministic_expansion=False)

    # ------------------------------------------------------------------
    # Slot pool
    # ------------------------------------------------------------------
    def _slot_rows0(self, root_states, rows: int) -> _BatchedAsyncSlots:
        """Fresh slot-pool rows (all FREE) for ``rows`` trees."""
        dev = root_states[0].device
        proto = self.evaluator.init_state(map_state(lambda x: x[0], root_states),
                                          (rows, self.W))

        def zeros(dtype):
            return torch.zeros((rows, self.W), dtype=dtype, device=dev)

        return _BatchedAsyncSlots(
            kind=zeros(torch.int64), sim_node=zeros(torch.int64), act=zeros(torch.int64),
            state=proto, rollout_done=zeros(torch.bool), acc=zeros(torch.float32),
            disc=torch.ones((rows, self.W), dtype=torch.float32, device=dev),
            steps=zeros(torch.int32),
        )

    def _set_slot(self, slots: _BatchedAsyncSlots, j: int, mask: torch.Tensor,
                  **kw) -> _BatchedAsyncSlots:
        """Write slot column ``j`` for trees where ``mask`` holds (in place)."""
        for name, new in kw.items():
            if name == "state":
                for buf, x in zip(slots.state, new):
                    m = mask.reshape((self.B,) + (1,) * (x.dim() - 1))
                    buf[:, j] = torch.where(m, x.to(buf.dtype), buf[:, j])
            else:
                buf = getattr(slots, name)
                buf[:, j] = torch.where(mask, new.to(buf.dtype), buf[:, j])
        return slots

    # ------------------------------------------------------------------
    # Master tick
    # ------------------------------------------------------------------
    def _refill(self, tree, slots: _BatchedAsyncSlots, rngs, t_launch, t_done, aux,
                fr_hits):
        """Fill each tree's FREE slots with fresh selections — slot ``j``
        of all ``B`` trees at once, one ``tree_descend`` call per column."""
        B, W, T, cfg = self.B, self.W, self.T, self.cfg
        dev = rngs.device
        bidx = torch.arange(B, device=dev)
        for j in range(W):
            rngs, k_t, k_e = _split_each(rngs, 3)
            want = (slots.kind[:, j] == FREE) & (t_launch < T)
            # A column no tree refills changes nothing but the keys (the
            # traversal only reads the tree): skip its work.
            if not host_any(want):
                continue
            nodes = traverse_batched(tree, k_t, cfg)
            kids = tree.children[bidx, nodes]
            n_tried = (kids >= 0).sum(dim=1)
            is_term = tree.terminal[bidx, nodes]
            at_depth = tree.depth[bidx, nodes] >= cfg.max_depth
            needs_exp = ~is_term & ~at_depth & (n_tried < self.width)
            act = _expansion_actions(tree, nodes, k_e, self._exp_cfg)
            tree, child, reserved = btree.reserve_children(tree, nodes, act,
                                                           mask=want & needs_exp)
            needs_exp = needs_exp & reserved
            sim_node = torch.where(needs_exp, child, nodes)
            tree = _mark_in_flight(tree, sim_node, cfg, mask=want)
            # Terminal hit: settle instantly, the slot stays FREE (a
            # completed simulation with return 0).
            tree = _settle(tree, sim_node, torch.zeros((B,), dtype=torch.float32, device=dev),
                           cfg, mask=want & is_term)
            parent_state = btree.get_state(tree, nodes)
            # Slot column j of every tree lives at flat aux row b·W + j.
            aux, hit = self.evaluator.refill_aux(cfg, aux, bidx * W + j, parent_state,
                                                 want & ~is_term)
            fr_hits = fr_hits + hit.to(fr_hits.dtype)
            kind = torch.where(is_term, FREE, torch.where(needs_exp, EXPAND, SIM))
            self._set_slot(
                slots, j, want, kind=kind, sim_node=sim_node, act=act,
                state=parent_state, rollout_done=tree.terminal[bidx, sim_node],
                acc=torch.zeros((B,), dtype=torch.float32, device=dev),
                disc=torch.ones((B,), dtype=torch.float32, device=dev),
                steps=torch.zeros((B,), dtype=torch.int32, device=dev),
            )
            t_launch = t_launch + want.to(t_launch.dtype)
            t_done = t_done + (want & is_term).to(t_done.dtype)
        return tree, slots, rngs, t_launch, t_done, aux, fr_hits

    def _tick(self, slots: _BatchedAsyncSlots, rngs: torch.Tensor, aux):
        """Advance every busy slot by one env step, as one flat ``[B·W]``
        batch through the evaluator."""
        from .. import rng

        B, W = self.B, self.W
        keys = rng.split(rngs, W).reshape(B * W, 2)

        def flat(x):
            return x.reshape((B * W,) + tuple(x.shape[2:]))

        out, aux = self.evaluator.tick(
            self.cfg, flat(slots.kind), flat(slots.act), map_state(flat, slots.state),
            flat(slots.rollout_done), flat(slots.acc), flat(slots.disc),
            flat(slots.steps), keys, aux,
        )

        def unflat(x):
            return x.reshape((B, W) + tuple(x.shape[1:]))

        new_state, r_edge, done_edge, acc, disc, steps, rollout_done = out
        slots = slots._replace(
            state=map_state(unflat, new_state), acc=unflat(acc), disc=unflat(disc),
            steps=unflat(steps), rollout_done=unflat(rollout_done),
        )
        return slots, unflat(r_edge), unflat(done_edge), aux

    def _settle_finished(self, tree, slots: _BatchedAsyncSlots, t_done, r_edge,
                         done_edge):
        """EXPAND→SIM transitions (finalize child) + completed rollouts."""
        cfg = self.cfg
        for j in range(self.W):
            kind_j = slots.kind[:, j].clone()
            is_exp = kind_j == EXPAND
            # EXPAND slots: their env step just produced the child state.
            st = map_state(lambda x: x[:, j], slots.state)
            tree = btree.finalize_children(tree, slots.sim_node[:, j], st, r_edge[:, j],
                                           done_edge[:, j], mask=is_exp)
            kind2 = torch.where(is_exp, SIM, kind_j)
            steps2 = torch.where(is_exp, 0, slots.steps[:, j])
            # SIM slots finished (episode done or step cap): complete update.
            fin = (kind2 == SIM) & (slots.rollout_done[:, j] | (steps2 >= cfg.max_sim_steps))
            tree = _settle(tree, slots.sim_node[:, j], slots.acc[:, j], cfg, mask=fin)
            slots.kind[:, j] = torch.where(fin, FREE, kind2)
            slots.steps[:, j] = steps2.to(slots.steps.dtype)
            t_done = t_done + fin.to(t_done.dtype)
        return tree, slots, t_done

    def alive(self, carry: Carry) -> torch.Tensor:
        """bool[B] — trees still short of their simulation budget."""
        return carry[4] < self.T

    def settled(self, carry: Carry) -> torch.Tensor:
        """bool[B] — trees whose search finished."""
        return carry[4] >= self.T

    def step(self, carry: Carry) -> Carry:
        """One master tick with finished trees frozen, as ``vmap`` of the
        single engine's ``while_loop`` freezes them.

        A finished tree's slots are masked FREE for the tick, so they feed
        the evaluator nothing and every tree and slot write is masked off
        for it (``want`` is false once ``t_launch >= T``; FREE slots keep
        their state and counters).  What the tick still moves for it — the
        RNG lane, the tick count and the masked slot kinds — is restored
        here.  The evaluator aux rides outside the freeze: a finished
        tree's slots are never fed again.
        """
        alive = self.alive(carry)
        tree, slots, rngs0, t_launch, t_done, ticks0, max_o0, aux, fr_hits = carry
        kind0 = slots.kind
        slots = slots._replace(kind=torch.where(alive[:, None], kind0, FREE))
        rngs, k_tick = _split_each(rngs0, 2)
        # A finished tree refills nothing (``want`` is false), so its hit
        # count does not move.
        tree, slots, rngs, t_launch, t_done, aux, fr_hits = self._refill(
            tree, slots, rngs, t_launch, t_done, aux, fr_hits)
        max_o = torch.maximum(max_o0, tree.O[:, 0])
        slots, r_edge, done_edge, aux = self._tick(slots, k_tick, aux)
        tree, slots, t_done = self._settle_finished(tree, slots, t_done, r_edge, done_edge)
        return (
            tree,
            slots._replace(kind=torch.where(alive[:, None], slots.kind, kind0)),
            torch.where(alive[:, None], rngs, rngs0),
            t_launch,
            t_done,
            torch.where(alive, ticks0 + 1, ticks0),
            torch.where(alive, max_o, max_o0),
            aux,
            fr_hits,
        )

    def init_carry(self, root_states: State, rngs: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> Carry:
        """The master-loop carry for ``B`` root states (leaves lead with
        ``[B]``) and key data ``rngs [B, 2]``.

        ``active`` (``bool[B]``, optional) marks rows that carry a real
        request; the others are born settled (``t_launch == t_done == T``),
        so :meth:`step` freezes them until :meth:`admit` splices a request
        in.  A caller with idle paged rows evicts them (:meth:`evict`), so their
        placeholder prefill pages return to the pool.
        """
        B = self.B
        dev = rngs.device

        def zeros(dtype):
            return torch.zeros((B,), dtype=dtype, device=dev)

        start = zeros(torch.int64)
        if active is not None:
            start = torch.where(torch.as_tensor(active, device=dev), 0, self.T).to(torch.int64)
        return (
            init_batched_tree(root_states, self.capacity, self.env.num_actions),
            self._slot_rows0(root_states, B), rngs.clone(),
            start, start.clone(), zeros(torch.int64),
            zeros(torch.float32),
            self.evaluator.init_aux(root_states, (B, self.W)),
            zeros(torch.int64),
        )

    # ------------------------------------------------------------------
    # Request lifecycle (the serving layer's surface)
    # ------------------------------------------------------------------
    def admit(self, carry: Carry, rows, root_states: State, rngs: torch.Tensor) -> Carry:
        """Splice fresh requests into settled rows, between ticks.

        ``rows`` (``i64[R]``, distinct, settled or idle); ``root_states``
        leaves lead with ``[R]``; ``rngs`` is key data ``[R, 2]``.  The rows'
        trees, slot pools, RNG lanes and counters are reset and their
        evaluator slot caches re-seeded (``Evaluator.admit_aux``); other
        rows' searches go on untouched.  Writes the carry in place.
        """
        tree, slots, rng_, t_launch, t_done, ticks, max_o, aux, fr_hits = carry
        dev = rng_.device
        rows = torch.as_tensor(rows, device=dev).to(torch.int64)

        def put(buf, new):
            if isinstance(buf, tuple):
                for b, n in zip(buf, new):
                    b[rows] = n.to(b.dtype)
            else:
                buf[rows] = new.to(buf.dtype)

        for buf, new in zip(tree, init_batched_tree(root_states, self.capacity,
                                                    self.env.num_actions)):
            put(buf, new)
        for buf, new in zip(slots, self._slot_rows0(root_states, rows.shape[0])):
            put(buf, new)
        rng_[rows] = rngs.to(device=dev, dtype=rng_.dtype)
        for counter in (t_launch, t_done, ticks, max_o, fr_hits):
            counter[rows] = 0
        aux = self.evaluator.admit_aux(self.cfg, aux, rows, root_states, self.W)
        return (tree, slots, rng_, t_launch, t_done, ticks, max_o, aux, fr_hits)

    def evict(self, carry: Carry, rows) -> Carry:
        """Release settled rows' evaluator-side resources without admitting:
        paged evaluators return the rows' pages to the pool; the others
        hold nothing to release.  Tree, slots and keys stay, so
        :meth:`result` stays readable until the row is re-admitted."""
        rows = torch.as_tensor(rows, device=carry[4].device).to(torch.int64)
        aux = self.evaluator.evict_aux(carry[7], rows, self.W)
        return carry[:7] + (aux,) + carry[8:]

    def run_segment(self, carry: Carry, num_ticks: int):
        """Up to ``num_ticks`` master ticks; stops early when all settled.
        Returns ``(carry, ticks_run, busy_tree_ticks)``."""
        t = 0
        busy = torch.zeros((), dtype=torch.int64, device=carry[4].device)
        while t < num_ticks and host_any(self.alive(carry)):
            busy = busy + self.alive(carry).sum()
            carry = self.step(carry)
            t += 1
        return carry, t, int(busy)

    def frontier_hits(self, carry: Carry) -> torch.Tensor:
        """i64[B] — refills answered from a frontier snapshot, per tree
        (zero for evaluators without a frontier cache)."""
        return carry[8]

    def result(self, carry: Carry) -> SearchResult:
        """``SearchResult[B]`` snapshot (meaningful on settled rows)."""
        tree = carry[0]
        root_n, root_v = btree.root_action_stats(tree)
        return SearchResult(
            action=btree.best_root_action(tree),
            root_n=root_n,
            root_v=root_v,
            tree_size=tree.size,
            dup_selections=torch.zeros((self.B,), dtype=torch.float32,
                                       device=root_n.device),
            max_o=carry[6],
            overflowed=tree.overflowed,
            ticks=carry[5],
        )

    def run(self, root_states: State, rngs: torch.Tensor, trace_ticks: int = 0):
        """Run every tree of one batch of roots to its budget.

        With ``trace_ticks > 0`` runs exactly that many master ticks (frozen
        ticks after every tree has settled included, as the reference's
        fixed-length scan; no loop-condition sync) and returns
        ``(SearchResult, AsyncTickTrace)`` with a ``[K, B, ...]`` trace:
        each snapshot taken after the tick, ``alive`` at its entry.
        """
        carry = self.init_carry(root_states, rngs)
        if trace_ticks > 0:
            from .async_search import stack_ticks, tick_snapshot

            ev = self.evaluator
            snaps = []
            for _ in range(trace_ticks):
                alive = self.alive(carry)
                carry = self.step(carry)
                cache_len = ev.aux_len(carry[7])
                if cache_len is not None:
                    cache_len = cache_len.reshape(self.B, self.W)
                snaps.append(tick_snapshot(carry, alive, cache_len, ev.aux_blocks(carry[7]),
                                           frontier_hits=carry[8]))
            return self.result(carry), stack_ticks(snaps)
        while host_any(self.alive(carry)):
            carry = self.step(carry)
        return self.result(carry)


def run_async_search_batched(env: Environment, cfg: SearchConfig, root_states: State,
                             rngs: torch.Tensor, trace_ticks: int = 0,
                             evaluator: Optional[Evaluator] = None):
    """Run ``B`` independent async-slot searches; every field of the
    returned :class:`SearchResult` carries a leading ``[B]`` axis.

    ``root_states`` leaves lead with ``[B]``; ``rngs`` is key data
    ``[B, 2]``.  With :class:`~repro_torch.core.evaluators.CachedModelEvaluator`
    every master tick is one batched ``decode_step`` over all slots.  With
    ``trace_ticks > 0`` returns ``(SearchResult, AsyncTickTrace)``
    (:meth:`BatchedAsyncEngine.run`).
    """
    engine = BatchedAsyncEngine(env, cfg, rngs.shape[0], evaluator=evaluator)
    return engine.run(root_states, rngs, trace_ticks)
