"""The batched async engine with a model evaluator under ``constrain=``.

Without a mesh the hook changes nothing: a search with
``constrain=constrain_search_batch`` equals the unconstrained one, field
for field, for all five llama evaluators.

On a spawned four-rank gloo world (``init_method=file://``, a 60 s
process-group timeout and the parent's join limit turn a hang into a
failure), a data-4 ``(4, 1)`` ``('data', 'model')`` mesh splits the ``B = 8``
trees two a rank, and each rank's slot aux holds its own trees' rows only.
The ranks import no JAX; a fifth process runs the one-process searches
and the parent the JAX package's meanwhile.  ``B = 8``, ``W = 4``, ``T = 12`` searches over
the reduced llama3-8b (vocab 64, 2 layers, d_model 32, float32) with the
uncached, cached, paged, frontier and paged frontier evaluators, over the
reduced mamba2-2.7b with ``ModelEvaluator``, and the wave and lockstep
engines with ``ModelEvaluator``; the parameters are the reference's
(``repro.models.init_params``, converted), and the roots and keys come
from numpy key data:

* one process's async searches, in the five llama modes and mamba2's,
  equal the reference's on the same parameters, roots and keys
  (``attn_impl="xla"``, the plain tree selection), trace mode included
  (``tests/test_torch_async.py`` holds the wave engine to it);
* the integer-valued fields of ``SearchResult`` equal one process's, and
  ``root_v`` and ``max_o`` agree within rtol 1e-5, atol 1e-6;
* trace mode with the paged frontier evaluator gives one process's
  ``AsyncTickTrace``, ``cache_len``, ``blocks_in_use`` and
  ``frontier_hits`` included;
* each rank's aux holds a quarter of one process's rows and bytes, and a
  paged pool ``num_blocks // 4`` blocks;
* no collective's result is larger than the gathered slot batch, while
  the caches are larger than it: no cache byte crosses the wire;
* ``num_blocks`` that 4 does not divide raises ``ValueError``; a pool that
  fits whole but not in one rank's share raises on every rank; a split
  pool is read through ``BatchedAsyncEngine.check_exhausted``, and the
  evaluator handed to the engine refuses a share on every rank;
* the share rides in the carry: a split carry run after the same engine
  made and ran a whole one gives one process's result.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(2)

B, W, T, K = 8, 4, 12, 4
PROMPT, MAX_LEN, EOS = (3, 5, 7), 14, 1
LLAMA = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
             head_dim=16, d_ff=64)
MAMBA = dict(vocab_size=64)
PAGED = dict(block_size=4, num_blocks=96)
MODES = ("model", "cached", "paged", "frontier", "paged_frontier")
RUNS = MODES + ("mamba2", "wave", "lockstep")
INT_FIELDS = ("action", "root_n", "tree_size", "ticks", "overflowed")
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
TRACE_TICKS = 20
ROOT_KEYS = np.random.default_rng(2).integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
SEARCH_KEYS = np.random.default_rng(1).integers(0, 2 ** 32, size=(B, 2), dtype=np.uint32)
# One rank's trees (0 and 1) hold 12-token prompts, three 4-token blocks
# each, the others 1-token prompts: 6 + 3 x 2 = 12 blocks fit a pool of 16
# whole, but rank 0's share of 4 does not.
RAGGED_POOL = 16
JOIN_LIMIT = 240.0
RANKS = 4


def _spec(engine="async", batch=B):
    from repro_torch.core import SearchSpec

    return SearchSpec(algo="wu_uct", engine=engine, batch=batch, num_simulations=T,
                      wave_size=W, max_depth=5, max_sim_steps=5, max_width=4, gamma=1.0)


def _overrides(name):
    return LLAMA if name == "llama3-8b" else MAMBA


def _model(inputs, name):
    """The port's reduced ``name`` on the reference's parameters."""
    from repro_torch import convert
    from repro_torch.configs import get_reduced

    cfg = get_reduced(name, **_overrides(name))
    return cfg, convert.params_from_numpy(inputs[name], cfg, device="cpu")


def _evaluator(mode, cfg, params, **paged):
    from repro_torch.core import (CachedModelEvaluator, FrontierModelEvaluator, ModelEvaluator,
                                  PagedCachedModelEvaluator, PagedFrontierModelEvaluator)

    kw = dict(top_k=K, eos_token=EOS)
    if mode in ("model", "mamba2", "wave", "lockstep"):
        return ModelEvaluator(cfg, params, **kw)
    if mode in ("cached", "frontier"):
        cls = CachedModelEvaluator if mode == "cached" else FrontierModelEvaluator
        return cls(cfg, params, **kw)
    cls = PagedCachedModelEvaluator if mode == "paged" else PagedFrontierModelEvaluator
    return cls(cfg, params, **kw, **{**PAGED, **paged})


def _cell(cfg, params):
    from repro_torch import convert
    from repro_torch.envs.token_env import make_token_env

    env = make_token_env(cfg, params, torch.tensor(PROMPT), max_len=MAX_LEN, top_k=K,
                         eos_token=EOS)
    return (env, env.init(convert.keys_from_numpy(ROOT_KEYS, device="cpu")),
            convert.keys_from_numpy(SEARCH_KEYS, device="cpu"))


def _ragged_roots():
    """Trees 0 and 1 on 12-token prompts, the others on 1-token ones."""
    from repro_torch.envs.token_env import TokenEnvState

    lengths = torch.tensor([12, 12] + [1] * (B - 2), dtype=torch.int32)
    pos = torch.arange(MAX_LEN)
    tokens = torch.where(pos[None, :] < lengths[:, None], 2 + (pos[None, :] % 50), 0)
    return TokenEnvState(tokens=tokens.to(torch.int32), length=lengths,
                         done=torch.zeros((B,), dtype=torch.bool))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _aux_size(aux):
    """(rows, bytes, pool blocks) of an evaluator's slot aux; the bytes
    leave out the scalars (a paged pool's ``oom``), one on every rank."""
    rows = (aux["tokens"] if "tokens" in aux else aux["last_logits"]).shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(aux) if t.dim())
    blocks = aux["refcount"].shape[0] if "refcount" in aux else 0
    return np.array([rows, nbytes, blocks])


def _result(out, tag, res):
    for f in res._fields:
        out[f"{tag}/{f}"] = np.asarray(getattr(res, f))


def _trace(out, trace):
    for f in trace._fields:
        if getattr(trace, f) is not None:
            out[f"trace/{f}"] = np.asarray(getattr(trace, f))


def _engine_search(out, tag, env, ev, roots, keys, constrain=None):
    """One search through the engine's own entry points, so that its
    carry's aux can be read; its collectives counted when ``constrain``
    splits it."""
    from repro_torch.core import BatchedAsyncEngine
    from repro_torch.distributed.collectives import CollectiveCounter

    engine = BatchedAsyncEngine(env, _spec().config, B, evaluator=ev, constrain=constrain)
    with CollectiveCounter() as counter:
        carry = engine.init_carry(roots, keys)
        out[f"{tag}/aux"] = _aux_size(carry[7])
        carry, _, _ = engine.run_segment(carry, 10 ** 9)
    _result(out, tag, engine.result(carry))
    events = counter.events
    out[f"{tag}/largest"] = np.array(max((e[2] for e in events), default=0))
    out[f"{tag}/kinds"] = np.array(sorted({e[0] for e in events}))
    out[f"{tag}/wire"] = np.array(sum(e[3] for e in events))
    slots = carry[1]
    # The tick's results, whole: the slots' states and counters, and the
    # edge rewards and flags.
    out[f"{tag}/batch_bytes"] = np.array(sum(
        t.numel() * t.element_size()
        for t in _tensors(slots.state) + [slots.acc, slots.disc, slots.steps,
                                          slots.rollout_done])
        + B * W * (4 + 1))
    return engine, carry


def _runs(out, inputs, constrain=None):
    """Every search of the file, split under ``constrain`` (inside a mesh)
    or in one process."""
    from repro_torch.core import build_searcher
    from repro_torch.core.batched_async_search import run_async_search_batched
    from repro_torch.envs.base import map_state

    cfg, params = _model(inputs, "llama3-8b")
    env, roots, keys = _cell(cfg, params)
    for mode in MODES:
        _engine_search(out, mode, env, _evaluator(mode, cfg, params), roots, keys, constrain)
    res, trace = run_async_search_batched(
        env, _spec().config, roots, keys, trace_ticks=TRACE_TICKS,
        evaluator=_evaluator("paged_frontier", cfg, params), constrain=constrain)
    _result(out, "trace/result", res)
    _trace(out, trace)
    hook = {} if constrain is None else {"constrain": constrain}
    _result(out, "lockstep", build_searcher(env, _spec("wave"), device="cpu",
                                            evaluator=_evaluator("lockstep", cfg, params),
                                            **hook)(roots, keys))
    _result(out, "wave", build_searcher(env, _spec("wave", 0), device="cpu",
                                        evaluator=_evaluator("wave", cfg, params),
                                        **hook)(map_state(lambda x: x[0], roots), keys[0]))
    mcfg, mparams = _model(inputs, "mamba2-2.7b")
    menv, mroots, mkeys = _cell(mcfg, mparams)
    _engine_search(out, "mamba2", menv, _evaluator("mamba2", mcfg, mparams), mroots, mkeys,
                   constrain)
    return cfg, params, env


def _reference(inputs):
    """The JAX package's searches of :func:`_runs`, on the same parameters,
    roots and keys."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced
    from repro.core import (CachedModelEvaluator, FrontierModelEvaluator, ModelEvaluator,
                            PagedCachedModelEvaluator, PagedFrontierModelEvaluator, SearchSpec,
                            build_searcher)
    from repro.core.batched_async_search import run_async_search_batched
    from repro.envs.token_env import make_token_env

    classes = dict(model=ModelEvaluator, cached=CachedModelEvaluator,
                   paged=PagedCachedModelEvaluator, frontier=FrontierModelEvaluator,
                   paged_frontier=PagedFrontierModelEvaluator, mamba2=ModelEvaluator,
                   trace=PagedFrontierModelEvaluator)
    out = {}
    keys = jnp.asarray(SEARCH_KEYS)
    for name, runs in (("llama3-8b", MODES + ("trace",)), ("mamba2-2.7b", ("mamba2",))):
        cfg = get_reduced(name, **_overrides(name))
        params = jax.tree.map(jnp.asarray, inputs[name])
        env = make_token_env(cfg, params, jnp.asarray(PROMPT), max_len=MAX_LEN, top_k=K,
                             eos_token=EOS)
        roots = jax.vmap(env.init)(jnp.asarray(ROOT_KEYS))
        for run in runs:
            cls = classes[run]
            ev = cls(cfg, params, top_k=K, eos_token=EOS,
                     **(PAGED if cls.__name__.startswith("Paged") else {}))
            spec = SearchSpec(**{**_spec()._asdict(), "use_kernel": False})
            if run == "trace":
                res, trace = run_async_search_batched(env, spec.config, roots, keys,
                                                      use_kernel=False,
                                                      trace_ticks=TRACE_TICKS, evaluator=ev)
                _result(out, "trace/result", res)
                _trace(out, trace)
            else:
                _result(out, run, build_searcher(env, spec, evaluator=ev)(roots, keys))
    return out


def _world(inputs):
    from repro_torch.core import BatchedAsyncEngine
    from repro_torch.distributed.sharding import (abstract_mesh, constrain_search_batch,
                                                  use_mesh)
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import PagePoolExhaustedError

    out = {}
    mesh = device_mesh(abstract_mesh((RANKS, 1), ("data", "model")), "cpu")
    with use_mesh(mesh):
        cfg, params, env = _runs(out, inputs, constrain_search_batch)
        _, roots, keys = _cell(cfg, params)
        uneven = _evaluator("paged", cfg, params, num_blocks=PAGED["num_blocks"] + 2)
        engine = BatchedAsyncEngine(env, _spec().config, B, evaluator=uneven,
                                    constrain=constrain_search_batch)
        try:
            engine.init_carry(roots, keys)
            out["uneven"] = np.array("")
        except ValueError as e:
            out["uneven"] = np.array(str(e))
        small = _evaluator("paged", cfg, params, num_blocks=RAGGED_POOL)
        engine = BatchedAsyncEngine(env, _spec().config, B, evaluator=small,
                                    constrain=constrain_search_batch)
        try:
            engine.init_carry(_ragged_roots(), keys)
            out["exhausted"] = np.array("")
        except PagePoolExhaustedError as e:
            out["exhausted"] = np.array(str(e))
        paged = _evaluator("paged", cfg, params)
        engine = BatchedAsyncEngine(env, _spec().config, B, evaluator=paged,
                                    constrain=constrain_search_batch)
        carry, _, _ = engine.run_segment(engine.init_carry(roots, keys), 10 ** 9)
        engine.check_exhausted(carry)
        try:
            paged.check_exhausted(carry[7])
            out["own_read"] = np.array("")
        except ValueError as e:
            out["own_read"] = np.array(str(e))
        engine = BatchedAsyncEngine(env, _spec().config, B,
                                    evaluator=_evaluator("cached", cfg, params),
                                    constrain=constrain_search_batch)
        split = engine.init_carry(roots, keys)
        share = split[9]
        out["share"] = np.array([share.lo, share.hi, share.parts])
    # The same engine makes and runs a whole carry outside the mesh, then
    # runs the split one on.
    whole, _, _ = engine.run_segment(engine.init_carry(roots, keys), 10 ** 9)
    out["whole_share"] = np.array(whole[9].parts)
    _result(out, "kept/whole", engine.result(whole))
    with use_mesh(mesh):
        split, _, _ = engine.run_segment(split, 10 ** 9)
    _result(out, "kept/split", engine.result(split))
    return out


def _one(inputs):
    """The one-process searches, and the blocks the ragged roots' prompts
    take in one whole pool."""
    from repro_torch.core import BatchedAsyncEngine

    one = {}
    cfg, params, env = _runs(one, inputs)
    _, _, keys = _cell(cfg, params)
    engine = BatchedAsyncEngine(env, _spec().config, B,
                                evaluator=_evaluator("paged", cfg, params,
                                                     num_blocks=RAGGED_POOL))
    one["ragged_blocks"] = np.array(int(engine.evaluator.aux_blocks(
        engine.init_carry(_ragged_roots(), keys)[7])))
    return one


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
    """The four ranks' split searches, a fifth process's one-process ones
    and the parent's reference ones, run at the same time."""
    tmp = str(tmp_path_factory.mktemp("split"))
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


# ---------------------------------------------------------------------------
# Without a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_constrain_without_a_mesh_changes_nothing(inputs, mode):
    from repro_torch.core import build_searcher
    from repro_torch.distributed.sharding import constrain_search_batch

    cfg, params = _model(inputs, "llama3-8b")
    env, roots, keys = _cell(cfg, params)
    plain = build_searcher(env, _spec(), evaluator=_evaluator(mode, cfg, params),
                           device="cpu")(roots, keys)
    hooked = build_searcher(env, _spec(), evaluator=_evaluator(mode, cfg, params),
                            device="cpu", constrain=constrain_search_batch)(roots, keys)
    for f in plain._fields:
        assert torch.equal(getattr(plain, f), getattr(hooked, f)), f


# ---------------------------------------------------------------------------
# One process against the reference
# ---------------------------------------------------------------------------


def _assert_same(res, want, keys, what):
    for k in keys:
        if k.endswith(("/root_v", "/max_o")) or want[k].dtype.kind == "f":
            np.testing.assert_allclose(res[k], want[k], **VALUE_TOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(res[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("run", MODES + ("mamba2",))
def test_one_process_equals_the_reference(world, run):
    _assert_same(world["one"], world["ref"], [f"{run}/{f}" for f in INT_FIELDS + (
        "root_v", "max_o")], "reference")


def test_one_process_trace_equals_the_reference(world):
    ref = world["ref"]
    fields = sorted(k for k in ref if k.startswith("trace/"))
    assert {"trace/cache_len", "trace/blocks_in_use", "trace/frontier_hits"} <= set(fields)
    assert sorted(k for k in world["one"] if k.startswith("trace/")) == fields
    _assert_same(world["one"], ref, fields, "reference")


# ---------------------------------------------------------------------------
# On the data-4 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", RUNS)
def test_split_search_equals_one_process(world, run):
    one = world["one"]
    for rank, res in enumerate(world["ranks"]):
        for f in INT_FIELDS:
            np.testing.assert_array_equal(res[f"{run}/{f}"], one[f"{run}/{f}"],
                                          err_msg=f"rank {rank} {run} {f}")
        for f in ("root_v", "max_o"):
            np.testing.assert_allclose(res[f"{run}/{f}"], one[f"{run}/{f}"], **VALUE_TOL,
                                       err_msg=f"rank {rank} {run} {f}")


def test_split_trace_equals_one_process(world):
    one = world["one"]
    fields = [k for k in one if k.startswith("trace/")]
    assert {"trace/cache_len", "trace/blocks_in_use", "trace/frontier_hits"} <= set(fields)
    assert int(one["trace/frontier_hits"][-1].sum()) > 0
    for rank, res in enumerate(world["ranks"]):
        assert sorted(k for k in res if k.startswith("trace/")) == sorted(fields)
        _assert_same(res, one, fields, f"rank {rank}")


@pytest.mark.parametrize("run", MODES + ("mamba2",))
def test_each_rank_holds_a_quarter_of_the_aux(world, run):
    rows, nbytes, blocks = world["one"][f"{run}/aux"]
    assert rows == B * W
    for rank, res in enumerate(world["ranks"]):
        got = res[f"{run}/aux"]
        assert list(got * RANKS) == [rows, nbytes, blocks], (rank, got)
        if run.startswith("paged"):
            assert got[2] == PAGED["num_blocks"] // RANKS
    shares = sorted(tuple(res["share"]) for res in world["ranks"])
    assert shares == [(r * 2, r * 2 + 2, RANKS) for r in range(RANKS)]


@pytest.mark.parametrize("run", MODES + ("mamba2",))
def test_no_collective_carries_a_cache(world, run):
    cache = world["one"][f"{run}/aux"][1]
    for rank, res in enumerate(world["ranks"]):
        batch = int(res[f"{run}/batch_bytes"])
        assert cache > batch, (cache, batch)
        assert 0 < int(res[f"{run}/largest"]) <= batch, (rank, res[f"{run}/largest"], batch)
        assert float(res[f"{run}/wire"]) > 0
        assert list(res[f"{run}/kinds"]) == ["all-gather"], res[f"{run}/kinds"]


def test_num_blocks_must_split_over_the_data_ranks(world):
    for res in world["ranks"]:
        assert "does not split over 4 data ranks" in str(res["uneven"])


def test_a_pool_exhausted_in_one_share_raises_on_every_rank(world):
    # The same pool holds every tree's prompt pages whole.
    assert int(world["one"]["ragged_blocks"]) <= RAGGED_POOL
    for res in world["ranks"]:
        assert "exhausted in a data rank's share" in str(res["exhausted"])


def test_a_split_pool_is_read_through_the_engine(world):
    for res in world["ranks"]:
        assert "read it through BatchedAsyncEngine.check_exhausted" in str(res["own_read"])


def test_the_share_rides_in_the_carry(world):
    one = world["one"]
    for rank, res in enumerate(world["ranks"]):
        assert int(res["whole_share"]) == 1
        for tag in ("kept/whole", "kept/split"):
            _assert_same({f"cached/{k.split('/')[-1]}": v for k, v in res.items()
                          if k.startswith(tag + "/")}, one,
                         [f"cached/{f}" for f in INT_FIELDS + ("root_v", "max_o")],
                         f"rank {rank} {tag}")
