"""The port's search engine against the JAX package, as a whole.

Both sides get the same root states and keys (numpy key data carried
across with ``repro_torch.convert``).  The JAX side runs with
``use_kernel=False`` where a whole search is compared, to keep the CPU
run short; its kernel path is pinned to that reference by
``tests/test_batched_search.py``.

On the bandit tree every draw is exact, so actions, visit counts, tree
sizes, overflow flags and ticks must be equal, and values agree within
``rtol=1e-6`` (XLA on the CPU fuses ``a * b + c`` into one FMA in the
value updates; the port rounds the product first).  On the tap game
``log`` enters the Gumbel expansion draws and the rollout policy, where a
last-bit difference can flip a near-tie: at least 7 of 8 trees must pick
the same action, and every divergence is reported.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.core import play_episode as jax_play_episode
from repro.core import batched_search as jbs
from repro.core import wu_uct as jwu
from repro.core.tree import Tree as JaxTree
from repro.core.batched_tree import init_batched_tree as jax_init_batched_tree
from repro.core.evaluators import RolloutEvaluator as JaxRolloutEvaluator
from repro.envs import make_bandit_tree as jax_bandit_tree
from repro.envs import make_tap_game as jax_tap_game
from repro_torch import convert
from repro_torch.core import SearchSpec, build_searcher, play_episode
from repro_torch.core import batched_search as tbs
from repro_torch.core.batched_search import run_search_batched
from repro_torch.core import wu_uct
from repro_torch.core.batched_tree import BatchedTree
from repro_torch.core.evaluators import RolloutEvaluator
from repro_torch.core.policies import PolicyConfig
from repro_torch.envs import make_bandit_tree, make_tap_game

torch.set_num_threads(2)

ALGOS = ("wu_uct", "uct", "treep", "treep_vc")
B = 8
BANDIT = dict(num_simulations=16, wave_size=4, max_depth=4, max_sim_steps=4,
              max_width=4, gamma=0.9)


def _key_data(seed, n=B):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _roots(jax_env, seed, n=B):
    j_roots = jax.vmap(jax_env.init)(jnp.asarray(_key_data(seed, n)))
    return j_roots, convert.state_from_numpy(_np(j_roots), device="cpu")


def _keys(seed, n=B):
    kd = _key_data(seed, n)
    return jnp.asarray(kd), convert.keys_from_numpy(kd, device="cpu")


def _assert_results_equal(ref, res):
    for field in ("action", "root_n", "tree_size", "overflowed", "ticks", "max_o",
                  "dup_selections"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    np.testing.assert_allclose(res.root_v.numpy(), np.asarray(ref.root_v), rtol=1e-6)


# ---------------------------------------------------------------------------
# Selection on a tree the JAX engine built
# ---------------------------------------------------------------------------


def _jax_mid_search_tree(jax_env, cfg, roots, rngs):
    """Two full waves, then a third selection phase whose expansions are
    still pending: visits, in-flight counts and pending children."""
    tree = jax_init_batched_tree(roots, cfg.num_simulations + cfg.wave_size + 1,
                                 jax_env.num_actions)
    for _ in range(2):
        rngs, k_sel, k_sim = jbs._split_each(rngs, 3)
        tree, slots, _ = jbs._phase1_select(tree, k_sel, cfg, False)
        out = jbs._phase2_work(jax_env, cfg, tree, slots, k_sim)
        tree = jbs._phase3_settle(tree, cfg, slots, *out)
    rngs, k_sel, _ = jbs._split_each(rngs, 3)
    tree, _, _ = jbs._phase1_select(tree, k_sel, cfg, False)
    return tree


@pytest.mark.parametrize("kind", ALGOS)
def test_select_and_phase1_on_converted_tree(kind):
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    spec = SearchSpec(algo=kind, **BANDIT)
    jcfg = JaxSearchSpec(algo=kind, **BANDIT).config
    pol = PolicyConfig(kind=kind, beta=1.3, r_vl=0.7, n_vl=1.5)
    j_pol = jcfg.policy._replace(beta=1.3, r_vl=0.7, n_vl=1.5)
    j_roots, _ = _roots(jax_env, 0)
    j_rngs, _ = _keys(1)
    j_walk, walk = _keys(3)
    others = np.random.default_rng(2).integers(0, 17, size=B).astype(np.int32)
    node_sets = np.stack([np.zeros(B, np.int32), others])

    @jax.jit
    def reference(roots, rngs, walk_keys, node_sets):
        tree = _jax_mid_search_tree(jax_env, jcfg, roots, rngs)
        nodes = jnp.minimum(node_sets, tree.size - 1)       # allocated nodes only
        selects = [jbs.batched_select(tree, n, j_pol, use_kernel=True) for n in nodes]
        stops = jbs.traverse_batched(tree, walk_keys, jcfg, False)
        single = JaxTree(*jax.tree.map(lambda x: x[B - 1], tuple(tree)))
        single_stop = jwu.traverse(single, walk_keys[B - 1], jcfg, use_kernel=False)
        return (tree, nodes, selects, stops, single_stop,
                jbs._phase1_select(tree, walk_keys, jcfg, False))

    (j_tree, j_nodes, j_selects, j_stops, j_single_stop,
     (j_tree2, j_slots, j_dups)) = reference(j_roots, j_rngs, j_walk, jnp.asarray(node_sets))
    tree = convert.tree_from_numpy(_np(j_tree), device="cpu")
    assert bool((tree.pending.any(dim=1) | (tree.O[:, 0] > 0)).any())

    # The fused select at the roots and at other allocated nodes.
    for nodes, (j_act, j_any) in zip(np.array(j_nodes), j_selects):
        act, any_valid = tbs.batched_select(tree, torch.from_numpy(nodes).long(), pol)
        np.testing.assert_array_equal(any_valid.numpy(), np.asarray(j_any))
        np.testing.assert_array_equal(act.numpy(), np.asarray(j_act))

    # A traversal (batched, and the single-tree B=1 view) and a whole
    # selection phase with the same keys.
    stops = tbs.traverse_batched(tree, walk, spec.config)
    np.testing.assert_array_equal(stops.numpy(), np.asarray(j_stops))
    single = BatchedTree(*(type(f)(*(x[B - 1] for x in f)) if isinstance(f, tuple)
                           else f[B - 1] for f in tree))
    assert int(wu_uct.traverse(single, walk[B - 1], spec.config)) == int(j_single_stop)
    tree2, slots, dups = tbs._phase1_select(tree, walk, spec.config)
    for f in slots._fields:
        np.testing.assert_array_equal(getattr(slots, f).numpy(),
                                      np.asarray(getattr(j_slots, f)), err_msg=f)
    np.testing.assert_array_equal(dups.numpy(), np.asarray(j_dups))
    for f in ("parent", "action", "children", "N", "O", "VL", "terminal", "pending",
              "depth", "size", "overflowed"):
        np.testing.assert_array_equal(getattr(tree2, f).numpy(),
                                      np.asarray(getattr(j_tree2, f)), err_msg=f)
    np.testing.assert_allclose(tree2.V.numpy(), np.asarray(j_tree2.V), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Whole searches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_batched_search_matches_jax(algo):
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    j_roots, roots = _roots(jax_env, 10)
    j_rngs, rngs = _keys(11)
    ref = jax_build_searcher(
        jax_env, JaxSearchSpec(algo=algo, batch=B, use_kernel=False, **BANDIT)
    )(j_roots, j_rngs)
    spec = SearchSpec(algo=algo, batch=B, **BANDIT)
    _assert_results_equal(ref, build_searcher(env, spec, device="cpu")(roots, rngs))
    _assert_results_equal(ref, run_search_batched(env, spec.config, roots, rngs))


@pytest.mark.parametrize("algo", ALGOS)
def test_single_root_search_matches_jax(algo):
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    j_search = jax_build_searcher(
        jax_env, JaxSearchSpec(algo=algo, batch=0, use_kernel=False, **BANDIT))
    search = build_searcher(env, SearchSpec(algo=algo, batch=0, **BANDIT), device="cpu")
    j_roots, roots = _roots(jax_env, 20, n=2)
    j_rngs, rngs = _keys(21, n=2)
    for i in range(2):
        ref = j_search(jax.tree.map(lambda x: x[i], j_roots), j_rngs[i])
        res = search(type(roots)(*(x[i] for x in roots)), rngs[i])
        assert res.root_n.shape == (4,)
        _assert_results_equal(ref, res)


def test_tap_game_search_matches_jax_on_most_trees():
    jax_env = jax_tap_game(6, 4, goal_count=10, step_budget=20)
    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    tap = dict(num_simulations=16, wave_size=4, max_depth=10, max_width=5,
               max_sim_steps=20)
    j_roots, roots = _roots(jax_env, 30)
    j_rngs, rngs = _keys(31)
    ref = jax_build_searcher(
        jax_env, JaxSearchSpec(algo="wu_uct", batch=B, use_kernel=False, **tap)
    )(j_roots, j_rngs)
    res = build_searcher(env, SearchSpec(algo="wu_uct", batch=B, **tap),
                         device="cpu")(roots, rngs)
    same = res.action.numpy() == np.asarray(ref.action)
    for i in np.flatnonzero(~same):
        print(f"tree {i} diverges: JAX action {int(ref.action[i])} root_n "
              f"{np.asarray(ref.root_n[i]).tolist()}; port action {int(res.action[i])} "
              f"root_n {res.root_n[i].tolist()}")
    assert same.sum() >= 7, f"actions equal on {same.sum()} of {B} trees"
    assert not bool(res.overflowed.any())


def test_play_episode_matches_jax():
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    j_spec = JaxSearchSpec(algo="wu_uct", use_kernel=False, **BANDIT)
    spec = SearchSpec(algo="wu_uct", **BANDIT)
    kd = _key_data(40, n=1)[0]
    ref = jax_play_episode(jax_env, j_spec.config, jnp.asarray(kd), max_moves=3,
                           searcher=jax_build_searcher(jax_env, j_spec, jit=False))
    key = convert.keys_from_numpy(kd, device="cpu")
    out = play_episode(env, spec.config, key, max_moves=3,
                       searcher=build_searcher(env, spec, device="cpu"), device="cpu")
    assert out == ref
    assert play_episode(env, spec.config, key, max_moves=3, device="cpu") == ref


@pytest.mark.parametrize("value_mix", [0.0, 0.5])
def test_rollout_value_bootstrap_and_mix_match_jax(value_mix):
    """Truncated rollouts add ``γ^T V(s_T)``; ``value_mix`` blends in V(s)."""
    jax_env = dataclasses.replace(jax_bandit_tree(depth=6, num_actions=4, seed=1),
                                  value_fn=lambda s: s.depth.astype(jnp.float32) * 0.25)
    env = dataclasses.replace(make_bandit_tree(depth=6, num_actions=4, seed=1),
                              value_fn=lambda s: s.depth.to(torch.float32) * 0.25)
    spec = dict(max_sim_steps=3, gamma=0.9, value_mix=value_mix)
    jcfg, cfg = JaxSearchSpec(**spec).config, SearchSpec(**spec).config
    n = 16
    acts = np.random.default_rng(70).integers(0, 4, size=(n,)).astype(np.int32)
    j_state, _, _ = jax.vmap(jax_env.step)(jax.vmap(jax_env.init)(jnp.zeros((n, 2), jnp.uint32)),
                                           jnp.asarray(acts))
    state = convert.state_from_numpy(_np(j_state), device="cpu")
    done = np.random.default_rng(71).random(n) < 0.25
    j_keys, keys = _keys(72, n=n)
    ref = jax.jit(jax.vmap(lambda s, d, k: JaxRolloutEvaluator(jax_env).rollout(jcfg, s, d, k)))(
        j_state, jnp.asarray(done), j_keys)
    out = RolloutEvaluator(env).rollout(cfg, state, torch.from_numpy(done), keys)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_rollout_evaluator_tick_matches_jax():
    """One master tick of FREE, EXPAND and SIM slots (slot_accounting)."""
    jax_env = jax_tap_game(6, 4, goal_count=10, step_budget=20)
    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    cfg = SearchSpec(**BANDIT).config
    jcfg = JaxSearchSpec(**BANDIT).config
    n = 12
    rs = np.random.default_rng(50)
    j_state, state = _roots(jax_env, 51, n=n)
    kind = rs.integers(0, 3, size=n).astype(np.int32)
    act = rs.integers(0, 36, size=n).astype(np.int32)
    done = rs.random(n) < 0.3
    acc = rs.random(n).astype(np.float32)
    disc = rs.random(n).astype(np.float32)
    steps = rs.integers(0, 5, size=n).astype(np.int32)
    j_keys, keys = _keys(52, n=n)
    ref, _ = jax.jit(lambda *a: JaxRolloutEvaluator(jax_env).tick(jcfg, *a))(
        jnp.asarray(kind), jnp.asarray(act), j_state, jnp.asarray(done),
        jnp.asarray(acc), jnp.asarray(disc), jnp.asarray(steps), j_keys)
    out, _ = RolloutEvaluator(env).tick(
        cfg, torch.from_numpy(kind).long(), torch.from_numpy(act).long(), state,
        torch.from_numpy(done), torch.from_numpy(acc), torch.from_numpy(disc),
        torch.from_numpy(steps), keys)
    new_state, r, d, acc2, disc2, steps2, rdone = out
    j_new_state, j_r, j_d, j_acc, j_disc, j_steps, j_rdone = ref
    for f in new_state._fields:
        expect = np.asarray(getattr(j_new_state, f))
        expect = expect.astype(np.int64) if expect.dtype == np.uint32 else expect
        np.testing.assert_array_equal(getattr(new_state, f).numpy(), expect, err_msg=f)
    np.testing.assert_array_max_ulp(r.numpy(), np.asarray(j_r), maxulp=1)
    np.testing.assert_allclose(acc2.numpy(), np.asarray(j_acc), rtol=1e-6)
    for x, y in ((d, j_d), (disc2, j_disc), (steps2, j_steps), (rdone, j_rdone)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
