"""The request lifecycle of the batched async engine on a split carry:
``admit``, ``evict`` and the request ring under ``constrain=``.

On a spawned four-rank gloo world (the harness of
``tests/test_torch_split_async.py``: ``init_method=file://``, a 60 s
process-group timeout and the parent's join limit), a data-4 ``(4, 1)``
``('data', 'model')`` mesh splits the ``B = 8`` trees two a rank, and each
rank's slot aux holds its own trees' rows.  Sixteen ragged prompts, keys
from numpy, go through ``B = 8``, ``W = 4``, ``T = 12`` searches (3-step
rollouts) over the reduced llama3-8b (vocab 64, 2 layers, float32) and the reduced
mamba2-2.7b, on the reference's parameters, converted.  A fifth process
runs the same drains through one process's whole engine, and the parent
the JAX package's unconstrained ``BatchedAsyncEngine``:

* host-paced drains (``init_carry(active=...)``, ``run_segment``, ``evict``
  of the settled rows, ``admit`` of the queued requests) in the five llama
  modes and mamba2's: every rank's result of each request equals one
  process's, and one process's the reference's (``action``, ``root_n``,
  ``tree_size``, ``ticks``, ``overflowed`` exact; ``root_v`` and ``max_o``
  within ``VALUE_TOL``), frontier hits included;
* fused drains (``stage`` + ``serve_segment``, a ring of 8, 2 a share) in
  the four cache modes and ``model``: each request, found by its
  ``req_id``, equals one process's whole ring and the split host-paced
  drain, within ``tests/test_torch_ring.py``'s bars;
* after both drains every rank's paged pool holds ``num_blocks // 4``
  blocks, none in use, every table at the sentinel and ``oom`` 0;
* a ring capacity that 4 does not divide raises ``ValueError``; staging
  that exhausts one share's pool raises on every rank through
  ``check_exhausted``;
* over a fused drain no collective is larger than the gathered slot
  batch, and every one is an all-gather;
* a split ``serve_segment`` costs the host syncs of a split
  ``run_segment`` over the same ticks.
"""

import collections
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_split_async import (EOS, INT_FIELDS, MAX_LEN, RANKS, VALUE_TOL, B, K, T, W,
                                    _evaluator, _model, _overrides)

torch.set_num_threads(2)

N = 16                        # requests
ACTIVE = 6                    # rows born with a request; the other two idle
SEG = 4                       # ticks a host-paced segment / a fused segment
RING = 8                      # ring capacity: 2 a share on 4 ranks
POOL = dict(block_size=4, num_blocks=128)
TINY_POOL = 8                 # 2 blocks a rank: one 12-token prompt exhausts a share
HOST_MODES = ("model", "cached", "paged", "frontier", "paged_frontier", "mamba2")
FUSED_MODES = ("model", "cached", "paged", "frontier", "paged_frontier")
PAGED_MODES = ("paged", "paged_frontier")
# The fused drains whose collectives are counted: a dense cache and a
# paged pool with its frontier snapshots (the counter's dispatch mode
# doubles a drain's time).
WIRE_MODES = ("cached", "paged_frontier")
FIELDS = INT_FIELDS + ("root_v", "max_o")
PROMPT_LEN = np.random.default_rng(3).integers(1, 9, size=N)
PROMPT_TOKENS = np.random.default_rng(4).integers(2, 64, size=(N, MAX_LEN)).astype(np.int32)
REQUEST_KEYS = np.random.default_rng(5).integers(0, 2 ** 32, size=(N, 2), dtype=np.uint32)
# The fused sync probe stages its B requests in this order, which the
# fewest-staged-first rule routes to shares 0, 1, 2, 3, 0, 1, 2, 3: share k
# then admits requests 2k and 2k + 1 into its rows 2k and 2k + 1, the rows
# the host-paced probe gives them.
PROBE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
JOIN_LIMIT = 240.0


def _spec():
    """``tests/test_torch_split_async.py``'s search with 3-step rollouts,
    so that a drain of 16 requests stays short."""
    from repro_torch.core import SearchSpec

    return SearchSpec(algo="wu_uct", engine="async", batch=B, num_simulations=T,
                      wave_size=W, max_depth=5, max_sim_steps=3, max_width=4, gamma=1.0)


def _prompts(ids):
    """Token ids, lengths and done flags of requests ``ids``, as numpy."""
    ids = np.asarray(ids)
    pos = np.arange(MAX_LEN)
    lengths = PROMPT_LEN[ids].astype(np.int32)
    tokens = np.where(pos[None, :] < lengths[:, None], PROMPT_TOKENS[ids], 0).astype(np.int32)
    return tokens, lengths, np.zeros(len(ids), dtype=bool)


def _roots(ids):
    from repro_torch.envs.token_env import TokenEnvState

    return TokenEnvState(*(torch.from_numpy(x) for x in _prompts(ids)))


def _keys(ids):
    from repro_torch import convert

    return convert.keys_from_numpy(REQUEST_KEYS[np.asarray(ids)], device="cpu")


def _env(cfg, params):
    from repro_torch.envs.token_env import make_token_env

    return make_token_env(cfg, params, torch.tensor([3, 5, 7]), max_len=MAX_LEN, top_k=K,
                          eos_token=EOS)


def _ev(mode, cfg, params, **pool):
    return _evaluator("model" if mode == "mamba2" else mode, cfg, params, **{**POOL, **pool})


def _record(out, tag, results):
    """Per-request results ``{req_id: {field: value}}`` as ``[N, ...]``
    arrays in request order."""
    assert sorted(results) == list(range(N)), sorted(results)
    for f in results[0]:
        out[f"{tag}/{f}"] = np.stack([np.asarray(results[i][f]) for i in range(N)])


def _host_paced(init, segment, settled, result, hits, admit, evict):
    """Drain the N requests host-paced: rows ``0 .. ACTIVE - 1`` are born
    with requests ``0 .. ACTIVE - 1`` and the others idle (evicted at
    once); each round harvests the settled rows holding a request, evicts
    them one by one, admits the queue's head into each free row, one
    ``admit`` a row, and runs one segment.  Returns ``{req_id: fields}``."""
    carry = init()
    row_req = [b if b < ACTIVE else None for b in range(B)]
    for b in range(ACTIVE, B):
        carry = evict(carry, b)
    queue = collections.deque(range(ACTIVE, N))
    results = {}
    while queue or any(r is not None for r in row_req):
        s = settled(carry)
        done = [b for b in range(B) if s[b] and row_req[b] is not None]
        if done:
            res, h = result(carry), hits(carry)
            for b in done:
                results[row_req[b]] = {**{f: res[f][b] for f in FIELDS}, "hits": h[b]}
                row_req[b] = None
                carry = evict(carry, b)
        for b in range(B):
            if s[b] and row_req[b] is None and queue:
                row_req[b] = queue.popleft()
                carry = admit(carry, b, row_req[b])
        if any(r is not None for r in row_req):
            carry = segment(carry)
    return carry, results


def _torch_host_paced(engine):
    def result(carry):
        res = engine.result(carry)
        return {f: np.asarray(getattr(res, f)) for f in FIELDS}

    return _host_paced(
        lambda: engine.init_carry(_roots(range(B)), _keys(range(B)),
                                  active=torch.arange(B) < ACTIVE),
        lambda c: engine.run_segment(c, SEG)[0],
        lambda c: np.asarray(engine.settled(c)),
        result,
        lambda c: np.asarray(engine.frontier_hits(c)),
        lambda c, b, q: engine.admit(c, torch.tensor([b]), _roots([q]), _keys([q])),
        lambda c, b: engine.evict(c, torch.tensor([b])))


def _idle_carry(engine):
    """A carry of ``B`` idle rows whose placeholder pages are back."""
    carry = engine.init_carry(_roots(range(B)), _keys(range(B)),
                              active=torch.zeros((B,), dtype=torch.bool))
    return engine.evict(carry, torch.arange(B))


def _fused(engine):
    """Drain the N requests through the ring: each round stages the queue's
    head until the ring is full (one ``stage`` a request) and runs one
    ``serve_segment``.  Returns ``(carry, ring, {req_id: fields})``."""
    carry = _idle_carry(engine)
    ring = engine.init_ring(carry, RING)
    row_req = torch.full((B,), -1, dtype=torch.int64)
    queue = collections.deque(range(N))
    staged = in_rows = 0
    results = {}
    while queue or staged or in_rows:
        while queue and staged < RING:
            q = queue.popleft()
            carry, ring = engine.stage(carry, ring, _roots([q]), _keys([q]), [q])
            staged += 1
        carry, ring, row_req, comp, _, _ = engine.serve_segment(carry, ring, row_req, SEG)
        for i, q in enumerate(comp.req_id[:comp.count].tolist()):
            results[q] = {f: np.asarray(getattr(comp, f)[i]) for f in FIELDS}
        left = int(ring.count.sum())
        in_rows += staged - left - comp.count
        staged = left
    return carry, ring, results


def _pool(aux, ring_aux=None):
    """(blocks, blocks in use, oom, every table at the sentinel) of a
    paged aux and its ring's staging."""
    p = aux["refcount"].shape[0]
    tables = [aux["table"]] + ([] if ring_aux is None else [ring_aux["table"]])
    return np.array([p, int((aux["refcount"] != 0).sum()), int(aux["oom"]),
                     int(all(bool((t == p).all()) for t in tables))])


def _batch_bytes(carry):
    """Bytes of the tick's whole results: the slots' states and counters,
    and the edge rewards and flags (``tests/test_torch_split_async.py``)."""
    slots = carry[1]
    leaves = list(slots.state) + [slots.acc, slots.disc, slots.steps, slots.rollout_done]
    return sum(t.numel() * t.element_size() for t in leaves) + B * W * (4 + 1)


def _drains(out, inputs, constrain=None):
    """Every drain of the file, split under ``constrain`` (inside a mesh)
    or in one process."""
    from repro_torch.core import BatchedAsyncEngine
    from repro_torch.distributed.collectives import CollectiveCounter

    for mode in HOST_MODES:
        cfg, params = _model(inputs, "mamba2-2.7b" if mode == "mamba2" else "llama3-8b")
        engine = BatchedAsyncEngine(_env(cfg, params), _spec().config, B,
                                    evaluator=_ev(mode, cfg, params), constrain=constrain)
        carry, res = _torch_host_paced(engine)
        _record(out, f"host/{mode}", res)
        if mode in PAGED_MODES:
            out[f"pool/host/{mode}"] = _pool(carry[7])
        if mode not in FUSED_MODES:
            continue
        if mode not in WIRE_MODES:
            carry, ring, res = _fused(engine)
        else:
            with CollectiveCounter() as counter:
                carry, ring, res = _fused(engine)
            events = counter.events
            out[f"wire/{mode}"] = np.array([max((e[2] for e in events), default=0),
                                            _batch_bytes(carry), len(events)])
            out[f"kinds/{mode}"] = np.array(sorted({e[0] for e in events}))
        _record(out, f"fused/{mode}", res)
        if mode in PAGED_MODES:
            out[f"pool/fused/{mode}"] = _pool(carry[7], ring.aux)


def _sync_probe(out, inputs, constrain):
    """The same B searches host-paced (``run_segment`` from a carry with
    every row admitted) and fused (``serve_segment`` admitting every row
    from a ring of B), each with the host sync count at 0 before."""
    from repro_torch.core import BatchedAsyncEngine
    from repro_torch.sync import SYNCS, reset_syncs

    cfg, params = _model(inputs, "llama3-8b")
    engine = BatchedAsyncEngine(_env(cfg, params), _spec().config, B,
                                evaluator=_ev("cached", cfg, params), constrain=constrain)
    carry = engine.init_carry(_roots(range(B)), _keys(range(B)))
    reset_syncs()
    carry, t, busy = engine.run_segment(carry, 10 ** 6)
    out["probe/run"] = np.array([t, busy, SYNCS["host_any"]])
    res = engine.result(carry)
    for f in FIELDS:
        out[f"probe/run/{f}"] = np.asarray(getattr(res, f))
    carry = _idle_carry(engine)
    ring = engine.init_ring(carry, B)
    for q in PROBE_ORDER:
        carry, ring = engine.stage(carry, ring, _roots([q]), _keys([q]), [q])
    row_req = torch.full((B,), -1, dtype=torch.int64)
    reset_syncs()
    carry, ring, row_req, comp, t, busy = engine.serve_segment(carry, ring, row_req, 10 ** 6)
    out["probe/fused"] = np.array([t, busy, SYNCS["host_any"]])
    out["probe/fused/rows"] = np.asarray(row_req)
    order = np.asarray(comp.req_id[:comp.count])
    for f in FIELDS:
        got = np.asarray(getattr(comp, f)[:comp.count])
        out[f"probe/fused/{f}"] = got[np.argsort(order)]
    out["probe/fused/req_id"] = np.sort(order)


def _limits(out, inputs, constrain):
    """A ring capacity that 4 does not divide, and staging that exhausts
    one share's pool."""
    from repro_torch.core import BatchedAsyncEngine
    from repro_torch.models import PagePoolExhaustedError

    cfg, params = _model(inputs, "llama3-8b")
    engine = BatchedAsyncEngine(_env(cfg, params), _spec().config, B,
                                evaluator=_ev("paged", cfg, params, num_blocks=TINY_POOL),
                                constrain=constrain)
    # Every placeholder root is one token: each tree's prompt takes one
    # block, a rank's two trees its two.
    carry = engine.init_carry(_roots([0] * B)._replace(length=torch.ones(B, dtype=torch.int32)),
                              _keys(range(B)), active=torch.zeros((B,), dtype=torch.bool))
    carry = engine.evict(carry, torch.arange(B))
    try:
        engine.init_ring(carry, RING - 2)
        out["uneven_ring"] = np.array("")
    except ValueError as e:
        out["uneven_ring"] = np.array(str(e))
    ring = engine.init_ring(carry, RING)
    long = _roots([0])._replace(
        tokens=torch.arange(2, 2 + MAX_LEN, dtype=torch.int32)[None],
        length=torch.tensor([12], dtype=torch.int32))
    carry, ring = engine.stage(carry, ring, long, _keys([0]), [0])
    out["staged_to"] = np.asarray(ring.count)
    out["own_oom"] = np.array(int(carry[7]["oom"]))
    try:
        engine.check_exhausted(carry)
        out["exhausted"] = np.array("")
    except PagePoolExhaustedError as e:
        out["exhausted"] = np.array(str(e))


def _world(inputs):
    from repro_torch.distributed.sharding import (abstract_mesh, constrain_search_batch,
                                                  use_mesh)
    from repro_torch.launch.mesh import device_mesh

    out = {}
    mesh = device_mesh(abstract_mesh((RANKS, 1), ("data", "model")), "cpu")
    with use_mesh(mesh):
        _drains(out, inputs, constrain_search_batch)
        _sync_probe(out, inputs, constrain_search_batch)
        _limits(out, inputs, constrain_search_batch)
    return out


def _one(inputs):
    out = {}
    _drains(out, inputs)
    _limits(out, inputs, None)
    return out


def _one_main(tmp, inputs):
    torch.set_num_threads(2)
    np.savez(os.path.join(tmp, "out_one.npz"), **_one(inputs))


def _rank_main(rank, tmp, inputs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=RANKS, timeout=datetime.timedelta(seconds=60))
    try:
        np.savez(os.path.join(tmp, f"out_{rank}.npz"), **_world(inputs))
    finally:
        dist.destroy_process_group()


def _reference(inputs):
    """The JAX package's host-paced drains of :func:`_drains`, through its
    unconstrained engine (jitted segment, admission and eviction, one row
    a call, as its ``SearchService`` runs them), on the same parameters,
    prompts and keys."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced
    from repro.core import (CachedModelEvaluator, FrontierModelEvaluator, ModelEvaluator,
                            PagedCachedModelEvaluator, PagedFrontierModelEvaluator, SearchSpec)
    from repro.core.batched_async_search import BatchedAsyncEngine
    from repro.envs.token_env import TokenEnvState, make_token_env

    classes = dict(model=ModelEvaluator, cached=CachedModelEvaluator,
                   paged=PagedCachedModelEvaluator, frontier=FrontierModelEvaluator,
                   paged_frontier=PagedFrontierModelEvaluator, mamba2=ModelEvaluator)

    def roots(ids):
        return TokenEnvState(*(jnp.asarray(x) for x in _prompts(ids)))

    def keys(ids):
        return jnp.asarray(REQUEST_KEYS[np.asarray(ids)])

    out = {}
    spec = SearchSpec(**{**_spec()._asdict(), "use_kernel": False})
    for mode in HOST_MODES:
        name = "mamba2-2.7b" if mode == "mamba2" else "llama3-8b"
        cfg = get_reduced(name, **_overrides(name))
        params = jax.tree.map(jnp.asarray, inputs[name])
        env = make_token_env(cfg, params, jnp.asarray([3, 5, 7]), max_len=MAX_LEN, top_k=K,
                             eos_token=EOS)
        cls = classes[mode]
        ev = cls(cfg, params, top_k=K, eos_token=EOS,
                 **(POOL if cls.__name__.startswith("Paged") else {}))
        engine = BatchedAsyncEngine(env, spec.config, B, evaluator=ev, use_kernel=False)
        segment = jax.jit(lambda c, engine=engine: engine.run_segment(c, SEG)[0])
        result = jax.jit(engine.result)
        admit, evict = jax.jit(engine.admit), jax.jit(engine.evict)

        def res_np(carry, result=result):
            res = result(carry)
            return {f: np.asarray(getattr(res, f)) for f in FIELDS}

        _, res = _host_paced(
            lambda engine=engine: engine.init_carry(roots(range(B)), keys(range(B)),
                                                    active=jnp.arange(B) < ACTIVE),
            segment,
            lambda c, engine=engine: np.asarray(engine.settled(c)),
            res_np,
            lambda c: np.asarray(c[8]),
            lambda c, b, q, admit=admit: admit(c, jnp.asarray([b], jnp.int32), roots([q]),
                                                keys([q])),
            lambda c, b, evict=evict: evict(c, jnp.asarray([b], jnp.int32)))
        _record(out, f"host/{mode}", res)
    return out


@pytest.fixture(scope="module")
def inputs():
    """The reference's parameters of both reduced models, as numpy."""
    import jax

    from repro.configs import get_reduced
    from repro.models import init_params

    def init(name):
        return jax.jit(lambda key: init_params(get_reduced(name, **_overrides(name)), key))(
            jax.random.PRNGKey(0))

    return {name: jax.tree.map(np.asarray, init(name)) for name in ("llama3-8b", "mamba2-2.7b")}


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    """The four ranks' split drains, a fifth process's one-process ones
    and the parent's reference ones, run at the same time."""
    tmp = str(tmp_path_factory.mktemp("lifecycle"))
    deadline = time.monotonic() + JOIN_LIMIT
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, inputs)) for r in range(RANKS)]
    procs.append(ctx.Process(target=_one_main, args=(tmp, inputs)))
    for p in procs:
        p.start()
    try:
        ref = _reference(inputs)
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"processes {hung} (4: one process) did not finish in {JOIN_LIMIT} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * (RANKS + 1), f"exit codes {codes}"
    ranks = [dict(np.load(os.path.join(tmp, f"out_{r}.npz"))) for r in range(RANKS)]
    return {"one": dict(np.load(os.path.join(tmp, "out_one.npz"))), "ranks": ranks,
            "ref": ref}


def _assert_same(got, want, tag, what, value_tol=VALUE_TOL):
    for f in FIELDS:
        if f in ("root_v", "max_o"):
            np.testing.assert_allclose(got[f"{tag}/{f}"], want[f"{tag}/{f}"], **value_tol,
                                       err_msg=f"{what} {tag} {f}")
        else:
            np.testing.assert_array_equal(got[f"{tag}/{f}"], want[f"{tag}/{f}"],
                                          err_msg=f"{what} {tag} {f}")


# ---------------------------------------------------------------------------
# Host-paced drains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", HOST_MODES)
def test_host_paced_one_process_equals_the_reference(world, mode):
    _assert_same(world["one"], world["ref"], f"host/{mode}", "reference")


@pytest.mark.parametrize("mode", HOST_MODES)
def test_split_host_paced_equals_one_process(world, mode):
    for rank, res in enumerate(world["ranks"]):
        _assert_same(res, world["one"], f"host/{mode}", f"rank {rank}")


@pytest.mark.parametrize("mode", ("frontier", "paged_frontier"))
def test_admitted_requests_frontier_hits_equal_one_process(world, mode):
    one = world["one"][f"host/{mode}/hits"]
    assert one.sum() > 0
    np.testing.assert_array_equal(world["ref"][f"host/{mode}/hits"], one)
    for rank, res in enumerate(world["ranks"]):
        np.testing.assert_array_equal(res[f"host/{mode}/hits"], one, err_msg=f"rank {rank}")


# ---------------------------------------------------------------------------
# Fused drains through the split ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_split_fused_equals_one_process_ring(world, mode):
    """Integers exact; root values within ``tests/test_torch_ring.py``'s
    bar for values computed in another arithmetic order (1e-6 relative):
    one process ticks and prefills the requests in other batches than a
    rank does."""
    for rank, res in enumerate(world["ranks"]):
        _assert_same(res, world["one"], f"fused/{mode}", f"rank {rank}",
                     dict(rtol=1e-6, atol=0))


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_split_fused_equals_split_host_paced(world, mode):
    """``tests/test_torch_ring.py``'s fused-against-host-paced bar:
    integers exact, root values within 1e-6 absolute."""
    for rank, res in enumerate(world["ranks"]):
        _assert_same({f"fused/{mode}/{f}": res[f"host/{mode}/{f}"] for f in FIELDS}, res,
                     f"fused/{mode}", f"rank {rank}", dict(rtol=0, atol=1e-6))


@pytest.mark.parametrize("drain", ("host", "fused"))
@pytest.mark.parametrize("mode", PAGED_MODES)
def test_every_share_of_the_pool_ends_empty(world, mode, drain):
    """(blocks, blocks in use, oom, tables at the sentinel) after the drain:
    a quarter of the pool a rank, all of it back."""
    assert list(world["one"][f"pool/{drain}/{mode}"]) == [POOL["num_blocks"], 0, 0, 1]
    for rank, res in enumerate(world["ranks"]):
        assert list(res[f"pool/{drain}/{mode}"]) == [POOL["num_blocks"] // RANKS, 0, 0, 1], rank


@pytest.mark.parametrize("mode", WIRE_MODES)
def test_no_collective_carries_a_cache(world, mode):
    for rank, res in enumerate(world["ranks"]):
        largest, batch, n = res[f"wire/{mode}"]
        assert n > 0 and 0 < largest <= batch, (rank, largest, batch, n)
        assert list(res[f"kinds/{mode}"]) == ["all-gather"], (rank, res[f"kinds/{mode}"])
    # One process issues none.
    assert world["one"][f"wire/{mode}"][2] == 0


def test_a_ring_capacity_must_split_over_the_data_ranks(world):
    assert str(world["one"]["uneven_ring"]) == ""
    for res in world["ranks"]:
        assert "does not split over 4 data ranks" in str(res["uneven_ring"])


def test_staging_that_exhausts_one_share_raises_on_every_rank(world):
    # The whole pool holds the request; a share of it does not.
    assert str(world["one"]["exhausted"]) == "" and int(world["one"]["own_oom"]) == 0
    ooms = []
    for res in world["ranks"]:
        assert list(res["staged_to"]) == [1, 0, 0, 0]
        assert "exhausted in a data rank's share" in str(res["exhausted"])
        ooms.append(int(res["own_oom"]))
    assert ooms[0] > 0 and ooms[1:] == [0] * (RANKS - 1), ooms


def test_split_serve_segment_costs_the_syncs_of_run_segment(world):
    for rank, res in enumerate(world["ranks"]):
        t, busy, syncs = res["probe/run"]
        assert t > 0 and list(res["probe/fused"]) == [t, busy, syncs], (
            rank, res["probe/run"], res["probe/fused"])
        np.testing.assert_array_equal(res["probe/fused/req_id"], np.arange(B))
        assert list(res["probe/fused/rows"]) == [-1] * B
        for f in FIELDS:
            np.testing.assert_allclose(res[f"probe/fused/{f}"], res[f"probe/run/{f}"],
                                       rtol=0, atol=1e-6, err_msg=f"rank {rank} {f}")
