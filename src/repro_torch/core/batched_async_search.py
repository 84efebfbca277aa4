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

With a ``constrain`` hook that splits the slot batch over the data ranks
of the ambient mesh (``constrain_search_batch``), each rank ticks its own
slots.  An evaluator with slot aux is split with them: each rank's aux
holds only its own trees' rows (trees ``lo .. hi - 1``, flat rows
``b·W + j`` for its ``b``), so each rank prefills, decodes and refills
against its own caches or pool.  Which rows those are rides in the carry
(:class:`SlotShare`, from :meth:`BatchedAsyncEngine.init_carry`), beside
the aux it describes; unsplit, the share is every tree.  The tree
statistics stay replicated; the tick's results, each tick's frontier hits
and trace mode's cache lengths and block counts come back to every rank,
and no cache byte crosses the wire.  A split paged pool is read through
:meth:`BatchedAsyncEngine.check_exhausted`, which sums its exhaustion
count over the ranks, so that every rank raises together.

Serving rests on two surfaces.  Host-paced: :meth:`BatchedAsyncEngine.admit`
and :meth:`~BatchedAsyncEngine.evict` between segments of
:meth:`~BatchedAsyncEngine.run_segment`.  Fused: a :class:`RequestRing` of
requests staged on the device ahead of time (:meth:`~BatchedAsyncEngine
.stage`, which also pre-prefills their caches), drained by
:meth:`~BatchedAsyncEngine.serve_segment`, whose tick loop harvests settled
rows into a :class:`Completions` buffer and re-seeds them from the ring
head without returning to the caller.  The reference runs that loop as
one ``lax.while_loop``; here it is a Python loop whose one host sync per
tick fetches the loop condition and the round's gate together (the rows
settled, the rows holding a request, the ring's count), so it pays no
sync per tick beyond ``run_segment``'s.  Harvest and admission then touch
only the rows concerned, by index.

Both surfaces run on a split carry.  Every rank is handed every request:
it resets every admitted row (the tree statistics are replicated), and
prefills, splices and releases the caches or pool pages of its own rows
only, through the share's evaluator, so that each request is prefilled,
and its pages allocated, on the rank that serves it.  A ring made for a
split carry (:meth:`BatchedAsyncEngine.init_ring`) is split like the
pool: one share of ``capacity // ranks`` slots a rank, its staged caches
or pages on that rank, the requests' ids, roots, keys and each share's
head and count on every rank.  :meth:`~BatchedAsyncEngine.stage` routes
each request to the share with the fewest staged requests (the lowest
first), and a share's requests are admitted into its own rank's rows.  A
request's result is the one a whole engine gives; the row and tick that
admit it may differ.  The lifecycle moves no cache byte between ranks:
a placed paged ``admit`` sums the pool's exhaustion count, and the fused
round adds no collective to the tick's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..envs.base import Environment, map_state
from ..sync import host_any, host_read
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
# t_done[B], ticks[B], max_o[B], aux, frontier_hits[B]), then the aux's
# SlotShare.
Carry = tuple


class SlotShare(NamedTuple):
    """Which trees a carry's slot aux holds: trees ``lo .. hi - 1`` of
    ``B`` (``parts`` equal shares over the data ranks), the mesh and
    placements the hook split the slots with (``None`` and ``()`` when the
    aux is whole), and the evaluator of the share
    (:meth:`~repro_torch.core.evaluators.Evaluator.for_shard`)."""

    lo: int
    hi: int
    parts: int
    mesh: Any
    placements: tuple
    evaluator: Evaluator

    @property
    def index(self) -> int:
        """This rank's place among the ``parts`` shares (0 when whole)."""
        return self.lo // (self.hi - self.lo)

    def own(self, rows: np.ndarray) -> np.ndarray:
        """Positions in ``rows`` (tree rows, on the host) of the rows this
        share holds."""
        return np.flatnonzero((rows >= self.lo) & (rows < self.hi))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole ``[B·…]`` tensor of every rank's rows ``x``, on every
        rank (one all-gather over the data ranks; ``x`` itself when the
        aux is whole)."""
        from ..distributed.sharding import gather_blocks

        return x if self.mesh is None else gather_blocks(x, self.mesh, self.placements)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (one element a rank) summed over the data ranks."""
        return x if self.mesh is None else self.gather(x).sum(dim=0, keepdim=True,
                                                               dtype=x.dtype)


class RequestRing(NamedTuple):
    """Staging buffer of pre-prefilled requests on the device: a
    fixed-capacity circular queue that :meth:`BatchedAsyncEngine.stage`
    fills between segments and :meth:`BatchedAsyncEngine.serve_segment`
    drains into rows as they settle.  ``aux`` holds the evaluator's staged
    resources (dense: prefilled KV rows and root logits; paged: a page
    table whose pool pages are written and held at refcount 1 by the ring).

    A ring made for a carry whose slot aux is split over ``parts`` data
    ranks (:meth:`BatchedAsyncEngine.init_ring`) is ``parts`` rings of
    ``C // parts`` slots, share ``k`` at slots ``k·C/parts ..``, each
    draining into the rows of the rank that holds trees share ``k``:
    ``head`` and ``count`` are then ``i64[parts]``, one per share, and
    ``aux`` holds only this rank's share.  The rest is on every rank.
    """

    req_id: torch.Tensor   # i64[C]  caller-assigned id, -1 = empty slot
    states: State          # [C, ...] root states
    rng: torch.Tensor      # [C, 2]  key data per request
    head: torch.Tensor     # i64[] (i64[parts] split)  oldest staged request
    count: torch.Tensor    # i64[] (i64[parts] split)  staged, not yet admitted
    aux: Any               # evaluator staging (Evaluator.init_ring_aux)


class Completions(NamedTuple):
    """What one :meth:`BatchedAsyncEngine.serve_segment` harvested: rows
    ``[0, count)`` are the :class:`SearchResult` snapshots of finished
    requests, taken at the tick their tree settled, with the ``req_id``
    they were staged under.  Capacity ``B + ring capacity``: everything in
    flight and everything staged can finish within one segment.  ``count``
    is known on the host (the harvest is decided there)."""

    req_id: torch.Tensor      # i64[C_out]
    action: torch.Tensor      # [C_out]
    root_n: torch.Tensor      # f32[C_out, A]
    root_v: torch.Tensor      # f32[C_out, A]
    tree_size: torch.Tensor   # [C_out]
    max_o: torch.Tensor       # f32[C_out]
    overflowed: torch.Tensor  # bool[C_out]
    ticks: torch.Tensor       # [C_out]
    count: int


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
                 evaluator: Optional[Evaluator] = None,
                 constrain: Optional[Callable[[Any], Any]] = None):
        self.env = env
        self.constrain = constrain
        self.cfg = cfg
        self.B = int(batch)
        self.W = cfg.wave_size
        self.T = cfg.num_simulations
        self.width = min(cfg.max_width, env.num_actions)
        self.capacity = cfg.num_simulations + cfg.wave_size + 1
        self.evaluator = evaluator if evaluator is not None else RolloutEvaluator(env)
        # The single async engine ignores deterministic_expansion.
        self._exp_cfg = cfg._replace(deterministic_expansion=False)

    def _split(self, device) -> SlotShare:
        """This rank's share of the trees: a part when ``constrain`` splits
        the ``[B·W]`` slot batch and the evaluator carries slot aux, else
        every tree.  The hook is asked with a probe of the flat row ids:
        the rows it leaves this rank must be whole trees."""
        B, W = self.B, self.W
        whole = SlotShare(0, B, 1, None, (), self.evaluator)
        if self.constrain is None or not self.evaluator.slot_aux:
            return whole
        from ..distributed.sharding import is_placed

        probe = self.constrain((torch.arange(B * W, device=device),))[0]
        if not is_placed(probe):
            return whole
        local = probe.to_local()
        lo = int(host_read(local[:1])[0]) // W if local.numel() else 0
        n = local.numel() // W
        trees = torch.arange(lo * W, (lo + n) * W, device=local.device)
        if n == 0 or B % n or local.numel() % W or not torch.equal(local, trees):
            raise ValueError(f"constrain splits the {B}x{W} slots across trees; an evaluator "
                             "with slot aux needs the data ranks to divide B")
        share = SlotShare(lo, lo + n, B // n, probe.device_mesh, tuple(probe.placements), None)
        return share._replace(evaluator=self.evaluator.for_shard(share.parts, share.reduce_sum))

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
                fr_hits, share: SlotShare):
        """Fill each tree's FREE slots with fresh selections — slot ``j``
        of all ``B`` trees at once, one ``tree_descend`` call per column.
        The aux refills the share's trees only."""
        B, W, T, cfg = self.B, self.W, self.T, self.cfg
        dev = rngs.device
        bidx = torch.arange(B, device=dev)
        lo, hi = share.lo, share.hi
        # The share's trees' hits, gathered once after the columns.
        local_hits = torch.zeros_like(fr_hits[lo:hi])
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
            # Slot column j of tree b lives at flat aux row (b - lo)·W + j.
            aux, hit = share.evaluator.refill_aux(
                cfg, aux, bidx[:hi - lo] * W + j, map_state(lambda x: x[lo:hi], parent_state),
                (want & ~is_term)[lo:hi])
            local_hits += hit.to(local_hits.dtype)
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
        return tree, slots, rngs, t_launch, t_done, aux, fr_hits + share.gather(local_hits)

    def _tick(self, slots: _BatchedAsyncSlots, rngs: torch.Tensor, aux, share: SlotShare):
        """Advance every busy slot by one env step, as one flat ``[B·W]``
        batch through the evaluator.  ``constrain`` is applied to that batch
        and to the results (the reference's hook): under a mesh each rank
        ticks its own slots against its own share of the slot aux, which
        never leaves the rank, and the results come back to every rank.
        Outside a mesh the hook changes nothing and the whole batch ticks
        against the whole aux."""
        from .. import rng

        B, W = self.B, self.W
        keys = rng.split(rngs, W).reshape(B * W, 2)

        def flat(x):
            return x.reshape((B * W,) + tuple(x.shape[2:]))

        args = (flat(slots.kind), flat(slots.act), map_state(flat, slots.state),
                flat(slots.rollout_done), flat(slots.acc), flat(slots.disc),
                flat(slots.steps), keys)
        ev = share.evaluator
        if self.constrain is None:
            out, aux = ev.tick(self.cfg, *args, aux)
        else:
            from ..distributed.sharding import local_apply

            rows = W * (share.hi - share.lo)
            box = [aux]

            def local_tick(*a):
                if ev.slot_aux and a[0].shape[0] != rows:
                    raise RuntimeError(f"{a[0].shape[0]} slots tick against slot aux of {rows} "
                                       "rows: step a carry under the mesh it was made under")
                o, box[0] = ev.tick(self.cfg, *a, box[0])
                return o

            out = self.constrain(local_apply(local_tick, self.constrain(args)))
            aux = box[0]

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
        tree, slots, rngs0, t_launch, t_done, ticks0, max_o0, aux, fr_hits, share = carry
        kind0 = slots.kind
        slots = slots._replace(kind=torch.where(alive[:, None], kind0, FREE))
        rngs, k_tick = _split_each(rngs0, 2)
        # A finished tree refills nothing (``want`` is false), so its hit
        # count does not move.
        tree, slots, rngs, t_launch, t_done, aux, fr_hits = self._refill(
            tree, slots, rngs, t_launch, t_done, aux, fr_hits, share)
        max_o = torch.maximum(max_o0, tree.O[:, 0])
        slots, r_edge, done_edge, aux = self._tick(slots, k_tick, aux, share)
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
            share,
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

        Where ``constrain`` splits the slots over the data ranks and the
        evaluator carries slot aux, the aux is this rank's share: each rank
        prefills its own trees only.  The carry's last element says which
        (:class:`SlotShare`), and the carry is stepped under the same mesh.
        """
        B = self.B
        dev = rngs.device

        def zeros(dtype):
            return torch.zeros((B,), dtype=dtype, device=dev)

        start = zeros(torch.int64)
        if active is not None:
            start = torch.where(torch.as_tensor(active, device=dev), 0, self.T).to(torch.int64)
        share = self._split(dev)
        aux = share.evaluator.init_aux(map_state(lambda x: x[share.lo:share.hi], root_states),
                                       (share.hi - share.lo, self.W))
        return (
            init_batched_tree(root_states, self.capacity, self.env.num_actions),
            self._slot_rows0(root_states, B), rngs.clone(),
            start, start.clone(), zeros(torch.int64),
            zeros(torch.float32), aux, zeros(torch.int64), share,
        )

    def check_exhausted(self, carry: Carry) -> None:
        """Raise :class:`~repro_torch.models.PagePoolExhaustedError` if a
        paged evaluator's pool ran out since :meth:`init_carry` (one host
        read).  A split pool's count is summed over the data ranks first,
        so every rank raises together: read a carry's pool through this,
        never through the evaluator handed to the engine."""
        carry[9].evaluator.check_exhausted(carry[7])

    # ------------------------------------------------------------------
    # Request lifecycle (the serving layer's surface)
    # ------------------------------------------------------------------
    def _reset_rows(self, carry: Carry, rows: torch.Tensor, root_states: State,
                    rngs: torch.Tensor) -> None:
        """Fresh trees, slot pools, RNG lanes and zero counters for tree
        rows ``rows``, in place; the evaluator aux is the caller's."""
        tree, slots, rng_, t_launch, t_done, ticks, max_o, _, fr_hits, _ = carry

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
        rng_[rows] = rngs.to(device=rng_.device, dtype=rng_.dtype)
        for counter in (t_launch, t_done, ticks, max_o, fr_hits):
            counter[rows] = 0

    def _local_rows(self, share: SlotShare, rows: torch.Tensor):
        """``(positions, local ids)`` of the tree rows ``rows`` that this
        rank's share holds: ``(None, rows)`` when the aux is whole, and
        ``None`` for the positions' tensor when the share holds none of them
        (one host read of ``rows`` when split)."""
        if share.parts == 1:
            return None, rows
        pos = share.own(host_read(rows))
        if not pos.size:
            return None, None
        pos = torch.from_numpy(pos).to(rows.device)
        return pos, rows[pos] - share.lo

    def admit(self, carry: Carry, rows, root_states: State, rngs: torch.Tensor) -> Carry:
        """Splice fresh requests into settled rows, between ticks.

        ``rows`` (``i64[R]``, distinct, settled or idle); ``root_states``
        leaves lead with ``[R]``; ``rngs`` is key data ``[R, 2]``.  The rows'
        trees, slot pools, RNG lanes and counters are reset and their
        evaluator slot caches re-seeded (``Evaluator.admit_aux``); other
        rows' searches go on untouched.  Writes the carry in place.

        On a split carry every rank is given every row, its root state and
        key: each resets them all (the tree statistics are replicated), and
        re-seeds the caches of its own rows only, so that each request is
        prefilled on the rank that serves it and a rank that holds none of
        the rows prefills nothing.  A placed pool's exhaustion is then read
        on every rank (:meth:`check_exhausted`), so that every rank raises
        together.
        """
        rows = torch.as_tensor(rows, device=carry[4].device).to(torch.int64)
        self._reset_rows(carry, rows, root_states, rngs)
        share = carry[9]
        pos, local = self._local_rows(share, rows)
        aux = carry[7]
        if local is not None:
            if pos is not None:
                root_states = map_state(lambda x: x[pos], root_states)
            aux = share.evaluator.admit_aux(self.cfg, aux, local, root_states, self.W)
        carry = carry[:7] + (aux,) + carry[8:]
        if share.mesh is not None:
            self.check_exhausted(carry)
        return carry

    def evict(self, carry: Carry, rows) -> Carry:
        """Release settled rows' evaluator-side resources without admitting:
        paged evaluators return the rows' pages to the pool; the others
        hold nothing to release.  Tree, slots and keys stay, so
        :meth:`result` stays readable until the row is re-admitted.  On a
        split carry each rank releases what its own rows hold."""
        rows = torch.as_tensor(rows, device=carry[4].device).to(torch.int64)
        share = carry[9]
        _, local = self._local_rows(share, rows)
        if local is None:
            return carry
        aux = share.evaluator.evict_aux(carry[7], local, self.W)
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

    # ------------------------------------------------------------------
    # The request ring (the fused serving round)
    # ------------------------------------------------------------------
    def init_ring(self, proto: State | Carry, capacity: int) -> RequestRing:
        """An empty :class:`RequestRing` of ``capacity`` requests for the
        carry ``proto``, whose root states give the shapes, types and
        device, and whose :class:`SlotShare` the split; or, for a whole
        ring, root states (leaves leading with any batch axis).

        Made for a carry whose slot aux is split over ``parts`` data ranks,
        the ring is split like it: each rank stages into a share of
        ``capacity // parts`` slots (``ValueError`` when ``parts`` does not
        divide ``capacity``), whose requests its own rows take.
        """
        cap = int(capacity)
        if cap < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        share = SlotShare(0, self.B, 1, None, (), self.evaluator)
        if isinstance(proto, tuple) and proto and isinstance(proto[-1], SlotShare):
            share = proto[9]
            proto = map_state(lambda x: x[:, 0], proto[1].state)
        if cap % share.parts:
            raise ValueError(f"ring capacity={cap} does not split over {share.parts} data "
                             "ranks: each rank's ring share holds capacity // ranks requests")
        dev = proto[0].device
        states = map_state(lambda x: torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                                                 device=dev), proto)
        zero = torch.zeros(() if share.parts == 1 else (share.parts,), dtype=torch.int64,
                           device=dev)
        return RequestRing(
            req_id=torch.full((cap,), -1, dtype=torch.int64, device=dev), states=states,
            rng=torch.zeros((cap, 2), dtype=torch.int64, device=dev), head=zero,
            count=zero.clone(),
            aux=share.evaluator.init_ring_aux(self.cfg, proto, cap // share.parts))

    @staticmethod
    def _ring_share(carry: Carry, ring: RequestRing) -> SlotShare:
        """The carry's share, which must split ``ring`` as it splits the
        slots."""
        share = carry[9]
        if ring.count.numel() != share.parts:
            raise ValueError(f"a ring of {ring.count.numel()} share(s) serves a carry split "
                             f"over {share.parts} data rank(s): make the ring with "
                             "init_ring(carry, capacity)")
        return share

    def stage(self, carry: Carry, ring: RequestRing, root_states: State, rngs: torch.Tensor,
              req_ids) -> tuple[Carry, RequestRing]:
        """Stage ``R`` requests at the ring's tail, between segments.

        The evaluator's ``stage_ring_aux`` pre-prefills them into the
        ring's staging buffers; paged evaluators allocate their pool pages
        now, from the live carry's refcounts, which is why the carry is
        threaded through.  The caller guarantees ``count + R <= capacity``.
        Writes the ring's buffers in place.

        A split ring is given every request on every rank.  Request by
        request, each goes to the share that holds the fewest staged
        requests, the lowest share first among equals: every rank computes
        this alike from the replicated counts (one host read), and a share
        with room always exists while the whole ring has room.  Each rank
        then prefills its own share's requests only, and a paged one
        allocates their pages from its own pool; exhaustion latches there
        (read it through :meth:`check_exhausted`).
        """
        share = self._ring_share(carry, ring)
        dev = ring.req_id.device
        cap = ring.req_id.shape[0]
        req_ids = torch.as_tensor(req_ids, device=dev).to(torch.int64)
        r = req_ids.shape[0]
        if share.parts == 1:
            slots = (ring.head + ring.count + torch.arange(r, device=dev)) % cap
            local, count, mine = slots, ring.count + r, None
        else:
            c = cap // share.parts
            head, counts = host_read(torch.stack([ring.head, ring.count])).copy()
            to = np.empty(r, dtype=np.int64)
            at = np.empty(r, dtype=np.int64)
            for i in range(r):
                k = int(np.argmin(counts))
                to[i], at[i] = k, (head[k] + counts[k]) % c
                counts[k] += 1
            slots = torch.from_numpy(to * c + at).to(dev)
            mine = torch.from_numpy(np.flatnonzero(to == share.index)).to(dev)
            local = torch.from_numpy(at).to(dev)[mine]
            count = torch.from_numpy(counts).to(dev)
        for buf, x in zip(ring.states, root_states):
            buf[slots] = x.to(buf.dtype)
        aux, ring_aux = carry[7], ring.aux
        if mine is None or mine.numel():
            aux, ring_aux = share.evaluator.stage_ring_aux(
                self.cfg, aux, ring_aux, local,
                root_states if mine is None else map_state(lambda x: x[mine], root_states))
        ring.req_id[slots] = req_ids
        ring.rng[slots] = rngs.to(device=dev, dtype=ring.rng.dtype)
        return carry[:7] + (aux,) + carry[8:], ring._replace(count=count, aux=ring_aux)

    def _gate(self, carry: Carry, ring: RequestRing, row_req: torch.Tensor):
        """One host sync: ``(settled bool[B], occupied bool[B], staged
        i64[parts])``, the loop condition and the round's gate together
        (``staged`` counts each ring share's requests)."""
        g = host_read(torch.cat([self.settled(carry).to(torch.int64),
                                 (row_req >= 0).to(torch.int64), ring.count.reshape(-1)]))
        return g[:self.B] > 0, g[self.B:2 * self.B] > 0, g[2 * self.B:]

    def _serve_round(self, carry: Carry, ring: RequestRing, row_req: torch.Tensor,
                     comp: Completions, settled, occupied, staged):
        """One harvest + admission round, decided on the host from the
        gate: settled rows holding a request append their result snapshot
        to ``comp`` (in row order) and release their evaluator resources
        (``evict_aux_to_ring``); then, share by share, as many of the
        share's settled rows as its ring share holds requests, in row order,
        are re-seeded from that share's head (the staged caches spliced by
        ``admit_aux_from_ring``, no prefill).  On a split carry every rank
        harvests and resets every row, and releases and splices its own
        rows only.  Only the rows concerned are touched.  Returns ``(carry,
        ring, row_req, comp, admitted)``."""
        dev = row_req.device
        share = carry[9]
        ev = share.evaluator
        done = np.flatnonzero(settled & occupied)
        if done.size:
            rows = torch.from_numpy(done).to(dev)
            dst = torch.arange(comp.count, comp.count + done.size, device=dev)
            res = self.result(carry)
            comp.req_id[dst] = row_req[rows]
            for name in Completions._fields[1:-1]:
                buf = getattr(comp, name)
                buf[dst] = getattr(res, name)[rows].to(buf.dtype)
            comp = comp._replace(count=comp.count + done.size)
            own = done[share.own(done)] - share.lo
            if own.size:
                aux = ev.evict_aux_to_ring(carry[7], torch.from_numpy(own).to(dev), self.W)
                carry = carry[:7] + (aux,) + carry[8:]
            row_req[rows] = -1
        parts = share.parts
        n, c = self.B // parts, ring.req_id.shape[0] // parts
        head = ring.head.reshape(-1)
        taken = np.zeros(parts, dtype=np.int64)
        rows, slots = [], []
        for k in range(parts):
            admit = np.flatnonzero(settled[k * n:(k + 1) * n])[:staged[k]]
            if not admit.size:
                continue
            taken[k] = admit.size
            at = (head[k] + torch.arange(admit.size, device=dev)) % c
            rows.append(torch.from_numpy(admit + k * n).to(dev))
            slots.append(k * c + at)
            if k == share.index:
                own_rows, own_slots = rows[-1] - share.lo, at
        if rows:
            rows, slots = torch.cat(rows), torch.cat(slots)
            self._reset_rows(carry, rows, map_state(lambda x: x[slots], ring.states),
                             ring.rng[slots])
            if taken[share.index]:
                aux, ring_aux = ev.admit_aux_from_ring(self.cfg, carry[7], ring.aux, own_slots,
                                                       own_rows, self.W)
                carry, ring = carry[:7] + (aux,) + carry[8:], ring._replace(aux=ring_aux)
            row_req[rows] = ring.req_id[slots]
            adm = int(taken[0]) if parts == 1 else torch.from_numpy(taken).to(dev)
            ring = ring._replace(head=(ring.head + adm) % c, count=ring.count - adm)
        return carry, ring, row_req, comp, int(taken.sum())

    def serve_segment(self, carry: Carry, ring: RequestRing, row_req: torch.Tensor,
                      num_ticks: int):
        """Up to ``num_ticks`` master ticks with harvest and ring admission
        inside the loop: the fused poll round.

        ``row_req`` (``i64[B]``) is the request id each row serves (``-1``:
        idle), updated in place.  Each tick first runs a harvest/admission
        round when a settled row holds a request or a settled row can take
        a staged one of its share, then one frozen-masked master tick; a
        last round after the loop harvests the rows that settled on the last
        tick.  The loop ends early once every row is idle and every ring
        share is empty.  Returns ``(carry, ring, row_req, completions,
        ticks_run, busy_tree_ticks)``; a split carry's completions, like its
        tree statistics, are on every rank.
        """
        share = self._ring_share(carry, ring)
        dev = row_req.device
        proto = self.result(carry)
        n = self.B // share.parts

        def buf(x):
            return torch.zeros((self.B + ring.req_id.shape[0],) + tuple(x.shape[1:]),
                               dtype=x.dtype, device=dev)

        comp = Completions(
            req_id=torch.full((self.B + ring.req_id.shape[0],), -1, dtype=torch.int64,
                              device=dev),
            action=buf(proto.action), root_n=buf(proto.root_n), root_v=buf(proto.root_v),
            tree_size=buf(proto.tree_size), max_o=buf(proto.max_o),
            overflowed=buf(proto.overflowed), ticks=buf(proto.ticks), count=0)

        def round_(carry, ring, row_req, comp, gate):
            settled, occupied, staged = gate
            if (settled & occupied).any() or (
                    (staged > 0) & settled.reshape(share.parts, n).any(axis=1)).any():
                return self._serve_round(carry, ring, row_req, comp, settled, occupied, staged)
            return carry, ring, row_req, comp, 0

        t = busy = 0
        gate = self._gate(carry, ring, row_req)
        while t < num_ticks and (not gate[0].all() or gate[2].any()):
            carry, ring, row_req, comp, admitted = round_(carry, ring, row_req, comp, gate)
            busy += int((~gate[0]).sum()) + admitted
            carry = self.step(carry)
            t += 1
            gate = self._gate(carry, ring, row_req)
        # The rows that settled on the last tick, without a masked tick for
        # them (admission here also primes the next segment's first tick).
        carry, ring, row_req, comp, _ = round_(carry, ring, row_req, comp, gate)
        return carry, ring, row_req, comp, t, busy

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

            share = carry[9]
            ev = share.evaluator
            snaps = []
            for _ in range(trace_ticks):
                alive = self.alive(carry)
                carry = self.step(carry)
                # Every rank's rows and blocks, as the unsplit trace has them.
                cache_len = ev.aux_len(carry[7])
                if cache_len is not None:
                    cache_len = share.gather(cache_len).reshape(self.B, self.W)
                blocks = ev.aux_blocks(carry[7])
                if blocks is not None:
                    blocks = share.reduce_sum(blocks.reshape(1)).reshape(())
                snaps.append(tick_snapshot(carry, alive, cache_len, blocks,
                                           frontier_hits=carry[8]))
            return self.result(carry), stack_ticks(snaps)
        while host_any(self.alive(carry)):
            carry = self.step(carry)
        return self.result(carry)


def run_async_search_batched(env: Environment, cfg: SearchConfig, root_states: State,
                             rngs: torch.Tensor, trace_ticks: int = 0,
                             evaluator: Optional[Evaluator] = None,
                             constrain: Optional[Callable[[Any], Any]] = None):
    """Run ``B`` independent async-slot searches; every field of the
    returned :class:`SearchResult` carries a leading ``[B]`` axis.

    ``root_states`` leaves lead with ``[B]``; ``rngs`` is key data
    ``[B, 2]``.  With :class:`~repro_torch.core.evaluators.CachedModelEvaluator`
    every master tick is one batched ``decode_step`` over all slots.  With
    ``trace_ticks > 0`` returns ``(SearchResult, AsyncTickTrace)``
    (:meth:`BatchedAsyncEngine.run`).
    """
    engine = BatchedAsyncEngine(env, cfg, rngs.shape[0], evaluator=evaluator,
                                constrain=constrain)
    return engine.run(root_states, rngs, trace_ticks)
