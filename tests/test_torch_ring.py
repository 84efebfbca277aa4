"""The fused request ring of the port's search serving against the
host-paced path and against the JAX package's ring.

The port's :class:`~repro_torch.serving.SearchService` with ``fused=True``
(the default: ``BatchedAsyncEngine.stage`` / ``serve_segment`` over a
:class:`~repro_torch.core.batched_async_search.RequestRing`) and the
reference's, over the tiny LM of ``tests/test_serving_continuous.py``
(vocab 64, one layer, float32, parameters converted from the reference's),
the same prompts and keys:

* in all four evaluator modes (dense, paged, frontier, paged frontier) the
  fused path equals the port's host-paced path and the reference's fused
  path on every request: action, root visit counts and tick counts exact;
  root values within 1e-6 absolute of the host-paced path's (the bar of
  ``tests/test_serving_continuous.py::test_fused_ring_matches_host_paced_poll``)
  and 1e-6 relative of the reference's (the port's bar for values against
  XLA, whose fused multiply-adds round the value updates differently:
  ROADMAP.md, "Parity first"); the serving counters equal the reference's;
* ring churn (twice the prompts through B = 2 rows and a 3-slot ring)
  returns every page, fails no allocation and leaves every table at the
  sentinel;
* priority-then-FIFO admission holds on the fused path;
* ``serve_segment`` costs the host syncs ``run_segment`` costs for the
  same ticks, and no more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import SearchSpec as JaxSearchSpec
from repro.core.evaluators import FrontierModelEvaluator as JaxFrontier
from repro.core.evaluators import PagedFrontierModelEvaluator as JaxPagedFrontier
from repro.models import init_params as jax_init_params
from repro.serving import SearchService as JaxSearchService
from repro_torch import convert, rng
from repro_torch.configs import get_reduced
from repro_torch.core import (
    CachedModelEvaluator,
    FrontierModelEvaluator,
    PagedFrontierModelEvaluator,
    SearchSpec,
)
from repro_torch.core.api import as_search_config
from repro_torch.core.batched_async_search import BatchedAsyncEngine
from repro_torch.envs import make_bandit_tree
from repro_torch.serving import SearchService
from repro_torch.sync import SYNCS, reset_syncs

torch.set_num_threads(2)

ARCH = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
            head_dim=16, d_ff=64)
PROMPTS = [[3, 5], [2, 9, 4], [7], [1, 2, 3], [5, 5], [6]]
SPEC = dict(algo="wu_uct", engine="async", num_simulations=6, wave_size=2, max_depth=3,
            max_sim_steps=3, max_width=4, gamma=1.0)
SERVICE = dict(top_k=4, max_len=12, eos_token=1, block_size=4, ticks_per_round=4)
MODES = ["dense", "paged", "frontier", "paged_frontier"]
STATS = ("submitted", "completed", "admissions", "ticks", "busy_tree_ticks", "host_rounds",
         "ring_occupancy_sum")


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = dataclasses.replace(jax_get_reduced("llama3-8b"), **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-8b", **ARCH)
    return jcfg, jp, cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                    device="cpu")


def _frontier_kw(mode, cls, paged_cls, cfg, params):
    if "frontier" not in mode:
        return {}
    if mode == "paged_frontier":
        return {"evaluator": paged_cls(cfg, params, top_k=4, eos_token=1, block_size=4,
                                       num_blocks=48)}
    return {"evaluator": cls(cfg, params, top_k=4, eos_token=1)}


def _service(tiny_lm, mode, batch=2, **kw):
    _, _, cfg, p = tiny_lm
    return SearchService(cfg, p, SearchSpec(batch=batch, **SPEC), paged="paged" in mode,
                         device="cpu", **{**SERVICE, **kw},
                         **_frontier_kw(mode, FrontierModelEvaluator,
                                        PagedFrontierModelEvaluator, cfg, p))


def _jax_service(tiny_lm, mode, batch=2):
    jcfg, jp, _, _ = tiny_lm
    return JaxSearchService(jcfg, jp, JaxSearchSpec(batch=batch, **SPEC),
                            paged="paged" in mode, **SERVICE,
                            **_frontier_kw(mode, JaxFrontier, JaxPagedFrontier, jcfg, jp))


def _keys(seed, n):
    return [np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), i)) for i in range(n)]


def _assert_rows_equal(got, want, **value_tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert int(a.action) == int(b.action)
        np.testing.assert_array_equal(np.asarray(a.root_n), np.asarray(b.root_n))
        np.testing.assert_allclose(np.asarray(a.root_v), np.asarray(b.root_v), **value_tol)
        assert int(a.ticks) == int(b.ticks)


def _pool_state(svc):
    """(pages held, oom, every slot table at the sentinel)."""
    aux = svc._carry[7]
    return (int((aux["refcount"] != 0).sum()), int(aux["oom"]),
            bool((aux["table"] == svc.evaluator.num_blocks).all()))


@pytest.mark.parametrize("mode", MODES)
def test_fused_equals_host_paced(tiny_lm, mode):
    keys = _keys(11, len(PROMPTS))
    fused = _service(tiny_lm, mode)
    rows = fused.serve(PROMPTS, keys=keys)
    _assert_rows_equal(rows, _service(tiny_lm, mode, fused=False).serve(PROMPTS, keys=keys),
                       rtol=0, atol=1e-6)
    st = fused.stats
    assert st.submitted == st.completed == st.admissions == len(PROMPTS)
    assert st.ring_occupancy > 0.0 and st.busy_tree_ticks <= st.ticks * st.batch
    if "paged" in mode:
        assert _pool_state(fused) == (0, 0, True)


@pytest.mark.parametrize("mode", MODES)
def test_fused_equals_reference_fused(tiny_lm, mode):
    """The same requests through the reference's default (fused) service:
    equal results and equal serving counters, host rounds included."""
    keys = _keys(11, len(PROMPTS))
    ref = _jax_service(tiny_lm, mode)
    assert ref.fused
    want = ref.serve(PROMPTS, keys=[jnp.asarray(k) for k in keys])
    svc = _service(tiny_lm, mode)
    assert svc.fused
    _assert_rows_equal(svc.serve(PROMPTS, keys=keys), want, rtol=1e-6, atol=0)
    for f in STATS:
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f
    assert svc.stats.ring_occupancy == ref.stats.ring_occupancy


@pytest.mark.parametrize("mode", ["paged", "paged_frontier"])
def test_ring_churn_leaks_no_page(tiny_lm, mode):
    """Twice the prompts through B = 2 rows and a 3-slot ring: every page
    the ring staged or a row held is back, no allocation failed, every
    slot and ring table is at the sentinel and the ring is empty."""
    svc = _service(tiny_lm, mode, ring_capacity=3)
    rows = svc.serve(PROMPTS + PROMPTS)
    assert len(rows) == 2 * len(PROMPTS) == svc.stats.completed == svc.stats.admissions
    assert _pool_state(svc) == (0, 0, True)
    ring = svc._ring
    assert bool((ring.aux["table"] == svc.evaluator.num_blocks).all())
    assert bool((ring.aux["len"] == 0).all()) and int(ring.count) == 0
    assert svc.stats.ring_occupancy > 0.0


@pytest.mark.parametrize("ring_capacity", [1, 4])
def test_priority_orders_admission_on_the_ring(tiny_lm, ring_capacity):
    """Higher priority admits first, ties in submission order: with one row,
    completion order is admission order, whatever the ring holds."""
    svc = _service(tiny_lm, "dense", batch=1, ring_capacity=ring_capacity)
    for i, pri in enumerate([0, 5, 1, 5]):
        svc.submit(PROMPTS[i], priority=pri)
    svc.drain()
    assert list(svc.results) == [1, 3, 2, 0]


def _lm_engine(tiny_lm):
    svc = _service(tiny_lm, "dense")
    assert isinstance(svc.evaluator, CachedModelEvaluator)
    engine = BatchedAsyncEngine(svc.env, as_search_config(svc.spec), 2,
                                evaluator=svc.evaluator)
    return engine, svc._root_rows(PROMPTS[:2])


def _bandit_engine(_):
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    cfg = SearchSpec(engine="async", num_simulations=16, wave_size=4, max_depth=4,
                     max_sim_steps=4, max_width=4, gamma=1.0).config
    return BatchedAsyncEngine(env, cfg, 3), env.init(rng.split(rng.PRNGKey(0), 3))


@pytest.mark.parametrize("make", [_bandit_engine, _lm_engine], ids=["bandit", "cached_lm"])
def test_serve_segment_adds_no_host_sync_per_tick(tiny_lm, make):
    """The same searches run host-paced (``run_segment`` from a carry with
    every row admitted) and fused (``serve_segment`` admitting every row
    from the ring): the same ticks and results, and the same host syncs
    (``repro_torch.sync.SYNCS``) — the gate fetch of each tick is the loop
    condition's one sync."""
    engine, roots = make(tiny_lm)
    b = engine.B
    keys = rng.split(rng.PRNGKey(5), b)

    carry = engine.init_carry(roots, keys)
    reset_syncs()
    carry, t_run, busy_run = engine.run_segment(carry, 1000)
    syncs_run = SYNCS["host_any"]
    res_run = engine.result(carry)

    idle = engine.init_carry(roots, keys, active=torch.zeros((b,), dtype=torch.bool))
    idle = engine.evict(idle, torch.arange(b))
    ring = engine.init_ring(roots, b)
    for i in range(b):
        idle, ring = engine.stage(idle, ring, type(roots)(*(x[i:i + 1] for x in roots)),
                                  keys[i:i + 1], [10 + i])
    row_req = torch.full((b,), -1, dtype=torch.int64)
    reset_syncs()
    _, ring, row_req, comp, t_fused, busy_fused = engine.serve_segment(idle, ring, row_req,
                                                                       1000)
    syncs_fused = SYNCS["host_any"]
    assert (t_fused, busy_fused) == (t_run, busy_run) and t_run > 0
    assert syncs_fused == syncs_run, (syncs_fused, syncs_run, t_run)
    assert comp.count == b and int(ring.count) == 0 and bool((row_req == -1).all())
    order = comp.req_id[:b].tolist()
    assert sorted(order) == [10 + i for i in range(b)]
    for i, rid in enumerate(order):
        r = rid - 10
        assert int(comp.action[i]) == int(res_run.action[r])
        assert torch.equal(comp.root_n[i], res_run.root_n[r])
        assert torch.equal(comp.root_v[i], res_run.root_v[r])
        assert int(comp.ticks[i]) == int(res_run.ticks[r])
