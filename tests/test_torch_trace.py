"""Trace mode of the port's async engines against the JAX package.

* **Bandit tree** (``tests/test_async_invariants.py``'s four ``CASES``, the
  single engine and the batched one at B = 3, the reference's trace
  bound): the port's ``AsyncTickTrace`` equals the reference's tick by
  tick in every field (``O``, ``parent``, ``kind``, ``sim_node``,
  ``t_done``, ``alive``, ``busy_slots``, ``active_trees``,
  ``frontier_hits``; every draw is exact there), and the reference's
  O-conservation checker passes on the port's trace.
* **Token search** over a tiny LM (vocab 64, one layer, float32) with the
  KV-cached and the paged evaluator: ``state_len``, ``cache_len`` and
  ``blocks_in_use`` equal the reference's, busy slots of live trees keep
  ``cache_len == state_len``, and the pool's working set stays within
  ``num_blocks``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import CachedModelEvaluator as JaxCached
from repro.core import PagedCachedModelEvaluator as JaxPaged
from repro.core import SearchSpec as JaxSearchSpec
from repro.core.async_search import run_async_search as jax_run_async
from repro.core.batched_async_search import run_async_search_batched as jax_run_batched
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import (
    AsyncTickTrace,
    CachedModelEvaluator,
    PagedCachedModelEvaluator,
    PolicyConfig,
    SearchConfig,
    SearchSpec,
)
from repro_torch.core.async_search import FREE, run_async_search
from repro_torch.core.batched_async_search import run_async_search_batched
from repro_torch.envs import make_bandit_tree, make_token_env
from test_async_invariants import CASES, _check_trace, _make, _trace_bound

torch.set_num_threads(2)

FIELDS = ("O", "parent", "kind", "sim_node", "t_done", "alive", "busy_slots",
          "active_trees", "frontier_hits")


def _port_cfg(depth, actions, T, W, sim_steps):
    return SearchConfig(num_simulations=T, wave_size=W, max_depth=depth + 2,
                        max_sim_steps=sim_steps, max_width=actions, gamma=0.95,
                        policy=PolicyConfig(kind="wu_uct"), stat_mode="wu")


def _numpy_trace(trace):
    return AsyncTickTrace(*(None if x is None else x.numpy() for x in trace))


def _assert_traces_equal(ref, got, fields):
    for f in fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batched"])
@pytest.mark.parametrize("depth,actions,T,W,sim_steps,seed", CASES)
def test_bandit_trace_equals_reference(batch, depth, actions, T, W, sim_steps, seed):
    jax_env, jax_cfg = _make(depth, actions, T, W, sim_steps, seed)
    env = make_bandit_tree(depth=depth, num_actions=actions, seed=seed)
    cfg = _port_cfg(depth, actions, T, W, sim_steps)
    K = _trace_bound(jax_cfg)
    if batch == 0:
        root = jax_env.init(jax.random.PRNGKey(seed))
        key = jax.random.PRNGKey(seed + 1)
        ref_res, ref = jax.jit(functools.partial(jax_run_async, jax_env, jax_cfg,
                                                 trace_ticks=K))(root, key)
        res, trace = run_async_search(
            env, cfg, convert.state_from_numpy(jax.tree.map(np.asarray, root), device="cpu"),
            convert.keys_from_numpy(np.asarray(key), device="cpu"), trace_ticks=K)
    else:
        roots = jax.vmap(jax_env.init)(jax.random.split(jax.random.PRNGKey(seed), batch))
        rngs = jax.random.split(jax.random.PRNGKey(seed + 1), batch)
        ref_res, ref = jax.jit(functools.partial(jax_run_batched, jax_env, jax_cfg,
                                                 trace_ticks=K))(roots, rngs)
        res, trace = run_async_search_batched(
            env, cfg, convert.state_from_numpy(jax.tree.map(np.asarray, roots), device="cpu"),
            convert.keys_from_numpy(np.asarray(rngs), device="cpu"), trace_ticks=K)
    _assert_traces_equal(ref, trace, FIELDS)
    for f in ("state_len", "cache_len", "blocks_in_use"):
        assert getattr(trace, f) is None and getattr(ref, f) is None, f
    np.testing.assert_array_equal(res.action.numpy(), np.asarray(ref_res.action))
    np.testing.assert_array_equal(res.root_n.numpy(), np.asarray(ref_res.root_n))
    # The reference's conservation checker on the port's own trace.
    port = _numpy_trace(trace)
    if batch == 0:
        port = AsyncTickTrace(*(None if x is None else x[:, None] for x in port))
    _check_trace(port, T, W)


def test_trace_without_trace_ticks_returns_the_plain_result():
    env = make_bandit_tree(depth=3, num_actions=3, seed=0)
    cfg = _port_cfg(3, 3, 12, 3, 4)
    keys = convert.keys_from_numpy(np.asarray(jax.random.split(jax.random.PRNGKey(1), 2)),
                                   device="cpu")
    roots = env.init(keys)
    plain = run_async_search_batched(env, cfg, roots, keys)
    traced, trace = run_async_search_batched(env, cfg, roots, keys, trace_ticks=80)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert trace.O.shape[:2] == (80, 2) and bool(trace.alive[0].all())
    assert not bool(trace.alive[-1].any()) and bool((trace.O[-1] == 0).all())


# ---------------------------------------------------------------------------
# Token search: cache depth and pool working set.
# ---------------------------------------------------------------------------

ARCH = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
            head_dim=16, d_ff=64)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = dataclasses.replace(jax_get_reduced("llama3-8b"), **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-8b", **ARCH)
    return jcfg, jp, cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                    device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["cached", "paged"])
def test_token_trace_cache_len_and_blocks_equal_reference(tiny_lm, paged):
    jcfg, jp, cfg, p = tiny_lm
    prompt = np.asarray([3, 5, 7], np.int32)
    kw = dict(top_k=4, eos_token=1)
    jax_env = jax_make_token_env(jcfg, jp, jnp.asarray(prompt), max_len=14, **kw)
    env = make_token_env(cfg, p, torch.from_numpy(prompt), max_len=14, **kw)
    if paged:
        jax_ev = JaxPaged(jcfg, jp, block_size=4, num_blocks=40, **kw)
        ev = PagedCachedModelEvaluator(cfg, p, block_size=4, num_blocks=40, **kw)
    else:
        jax_ev, ev = JaxCached(jcfg, jp, **kw), CachedModelEvaluator(cfg, p, **kw)
    spec = dict(algo="wu_uct", engine="async", num_simulations=10, wave_size=3,
                max_depth=5, max_sim_steps=5, max_width=4, gamma=1.0)
    B, K = 2, 40
    kd = np.asarray(jax.random.split(jax.random.PRNGKey(0), B))
    rd = np.asarray(jax.random.split(jax.random.PRNGKey(1), B))
    ref_res, ref = jax.jit(functools.partial(
        jax_run_batched, jax_env, JaxSearchSpec(**spec).config, trace_ticks=K,
        evaluator=jax_ev))(jax.vmap(jax_env.init)(jnp.asarray(kd)), jnp.asarray(rd))
    res, trace = run_async_search_batched(
        env, SearchSpec(**spec).config, env.init(convert.keys_from_numpy(kd, device="cpu")),
        convert.keys_from_numpy(rd, device="cpu"), trace_ticks=K, evaluator=ev)

    fields = ("kind", "sim_node", "t_done", "alive", "busy_slots", "state_len", "cache_len")
    _assert_traces_equal(ref, trace, fields + (("blocks_in_use",) if paged else ()))
    np.testing.assert_array_equal(res.root_n.numpy(), np.asarray(ref_res.root_n))
    kind, alive = trace.kind.numpy(), trace.alive.numpy()
    state_len, cache_len = trace.state_len.numpy(), trace.cache_len.numpy()
    assert alive.any() and not alive.all(), "trace bound too tight"
    busy = (kind != FREE) & alive[..., None]
    assert busy.sum() > 0
    np.testing.assert_array_equal(cache_len[busy], state_len[busy])
    if paged:
        blocks = trace.blocks_in_use.numpy()
        assert blocks.shape == (K,) and 0 < blocks[alive.any(1)].max() <= ev.num_blocks
    else:
        assert trace.blocks_in_use is None
