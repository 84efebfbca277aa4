"""The paper's baselines in the port against the JAX package.

* ``leafp``, ``rootp`` and ``treep`` through ``build_searcher`` on the
  bandit tree (every draw exact): actions and root visit counts equal to
  ``repro.core.baselines``', root values within rtol = 1e-6 (XLA fuses
  ``a * b + c`` in the value updates, ROADMAP.md rules); on the tap game,
  where a ``log`` ulp can flip a near-tie, at least 7 of 8 roots choose
  the same action;
* ``make_algorithm`` runs what ``build_searcher`` runs;
* the refusals (``leafp``/``rootp`` on the async engine or batched) raise
  the reference's ``ValueError``\\ s;
* ``init_tree`` and ``make_config`` equal the reference's, and the paper's
  ``ATARI``/``TAP_GAME`` configs field for field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wu_uct_paper as jax_paper
from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.core import init_tree as jax_init_tree
from repro.core import make_config as jax_make_config
from repro.envs import make_bandit_tree as jax_bandit_tree
from repro.envs import make_tap_game as jax_tap_game
from repro_torch import convert
from repro_torch.configs import wu_uct_paper
from repro_torch.core import SearchSpec, build_searcher, init_tree, make_config
from repro_torch.core.baselines import ALGORITHMS, make_algorithm
from repro_torch.envs import make_bandit_tree, make_tap_game

torch.set_num_threads(2)

BASELINES = ("leafp", "rootp", "treep")
BANDIT = dict(num_simulations=16, wave_size=4, max_depth=4, max_sim_steps=4,
              max_width=4, gamma=0.9)
TAP = dict(num_simulations=16, wave_size=4, max_depth=10, max_width=5, max_sim_steps=20)


def _pairs(jax_env, seed, n):
    """``n`` (reference root, port root, reference key, port key) tuples."""
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    rk = np.random.default_rng(seed + 1).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    out = []
    for i in range(n):
        root = jax_env.init(jnp.asarray(kd[i]))
        out.append((root, convert.state_from_numpy(jax.tree.map(np.asarray, root), device="cpu"),
                    jnp.asarray(rk[i]), convert.keys_from_numpy(rk[i], device="cpu")))
    return out


def _run_both(jax_env, env, algo, spec, seed, n):
    j_search = jax_build_searcher(jax_env, JaxSearchSpec(algo=algo, use_kernel=False, **spec))
    search = build_searcher(env, SearchSpec(algo=algo, **spec), device="cpu")
    return [(j_search(jr, jk), search(r, k)) for jr, r, jk, k in _pairs(jax_env, seed, n)]


@pytest.mark.parametrize("algo", BASELINES)
def test_bandit_search_equals_reference(algo):
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    for ref, res in _run_both(jax_env, env, algo, BANDIT, seed=0, n=6):
        assert res.root_n.shape == (4,) and res.action.dim() == 0
        for f in ("action", "root_n", "tree_size", "overflowed", "ticks", "dup_selections",
                  "max_o"):
            np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
        np.testing.assert_allclose(res.root_v.numpy(), np.asarray(ref.root_v), rtol=1e-6)


@pytest.mark.parametrize("algo", BASELINES)
def test_tap_game_search_agrees_on_most_roots(algo):
    jax_env = jax_tap_game(6, 4, goal_count=10, step_budget=20)
    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    runs = _run_both(jax_env, env, algo, TAP, seed=30, n=8)
    same = [int(ref.action) == int(res.action) for ref, res in runs]
    for i, (ref, res) in enumerate(runs):
        if not same[i]:
            print(f"{algo} root {i}: JAX action {int(ref.action)} root_n "
                  f"{np.asarray(ref.root_n).tolist()}; port {int(res.action)} "
                  f"{res.root_n.tolist()}")
        assert not bool(res.overflowed)
    assert sum(same) >= 7, f"{algo}: actions equal on {sum(same)} of 8 roots"


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_make_algorithm_equals_build_searcher(algo):
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    spec = SearchSpec(algo=algo, **BANDIT)
    direct = make_algorithm(algo, env, spec.config)
    built = build_searcher(env, spec, device="cpu")
    for _, root, _, key in _pairs(jax_bandit_tree(depth=4, num_actions=4, seed=3), 5, 2):
        for a, b in zip(direct(root, key), built(root, key)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ["leafp", "rootp"])
def test_refusals_match_the_reference(algo):
    env, jax_env = make_bandit_tree(depth=3, num_actions=3), jax_bandit_tree(depth=3, num_actions=3)
    for kw in (dict(engine="async"), dict(batch=2), dict(engine="async", batch=2)):
        with pytest.raises(ValueError) as ref:
            jax_build_searcher(jax_env, JaxSearchSpec(algo=algo, **kw))
        with pytest.raises(ValueError) as got:
            build_searcher(env, SearchSpec(algo=algo, **kw), device="cpu")
        assert str(got.value) == str(ref.value)


def test_init_tree_equals_reference():
    jax_env = jax_tap_game(6, 4, goal_count=10, step_budget=20)
    (jroot, root, _, _), = _pairs(jax_env, 40, 1)
    ref = jax_init_tree(jroot, 9, 36)
    tree = init_tree(root, 9, 36)
    assert tree.capacity == ref.capacity and tree.num_actions == ref.num_actions
    for f in ref._fields:
        if f == "states":
            for a, b in zip(ref.states, tree.states):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
        else:
            np.testing.assert_array_equal(getattr(tree, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)


@pytest.mark.parametrize("algo", ["wu_uct", "uct", "treep", "treep_vc", "leafp", "rootp"])
def test_make_config_equals_reference(algo):
    kw = dict(num_simulations=32, wave_size=8, beta=0.5, r_vl=2.0)
    for extra in ({}, {"stat_mode": "none"}):
        ref, got = jax_make_config(algo, **kw, **extra), make_config(algo, **kw, **extra)
        assert tuple(got.policy) == tuple(ref.policy)
        assert got._replace(policy=None) == ref._replace(policy=None)


@pytest.mark.parametrize("name", ["ATARI", "TAP_GAME"])
def test_paper_configs_equal_reference(name):
    ref, got = getattr(jax_paper, name), getattr(wu_uct_paper, name)
    assert got._fields == ref._fields
    assert tuple(got.policy) == tuple(ref.policy)
    for f in ref._fields:
        if f != "policy":
            assert getattr(got, f) == getattr(ref, f), f


def test_single_tree_updates_equal_reference():
    """``reserve_child``, ``finalize_child`` and ``backprop_update`` on one
    tap-game tree, as ``repro.core.tree``'s, up to a refused reservation
    at capacity."""
    from repro.core import tree as jax_tree
    from repro_torch.core import tree as tree_lib

    jax_env = jax_tap_game(6, 4, goal_count=10, step_budget=20)
    (jroot, root, _, _), = _pairs(jax_env, 50, 1)
    jt, t = jax_tree.init_tree(jroot, 4, 36), tree_lib.init_tree(root, 4, 36)
    for parent, act in ((0, 3), (1, 7), (1, 9), (2, 0)):
        jt, jc, jok = jax_tree.reserve_child(jt, jnp.int32(parent), jnp.int32(act))
        t, c, ok = tree_lib.reserve_child(t, torch.tensor(parent), torch.tensor(act))
        assert (int(c), bool(ok)) == (int(jc), bool(jok))
        if bool(jok):
            st, r, d = jax_env.step(jax_tree.get_state(jt, jnp.int32(parent)), jnp.int32(act))
            jt = jax_tree.finalize_child(jt, jc, st, r, d)
            tree_lib.finalize_child(t, c, convert.state_from_numpy(
                jax.tree.map(np.asarray, st), device="cpu"), torch.tensor(float(r)),
                torch.tensor(bool(d)))
        jt = jax_tree.backprop_update(jt, jc, jnp.float32(0.25 * act), 0.9)
        tree_lib.backprop_update(t, c, torch.tensor(0.25 * act), 0.9)
    assert bool(t.overflowed) and bool(jt.overflowed)
    for f in (f for f in jt._fields if f not in ("states", "V")):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(t.V.numpy(), np.asarray(jt.V), rtol=1e-6)
    for a, b in zip(jt.states, t.states):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
    n, v = tree_lib.root_action_stats(t)
    jn, jv = jax_tree.root_action_stats(jt)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(tree_lib.best_root_action(t)) == int(jax_tree.best_root_action(jt))


def test_leafp_backups_equal_sequential_backprop():
    """LeafP's W back-ups of one node, the path walked once, equal W
    ``backprop_update`` calls one after another, bit for bit."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.baselines import _backup_each

    env = make_bandit_tree(depth=4, num_actions=3, seed=1)
    roots = env.init(torch.zeros((1, 2), dtype=torch.int64))
    root = type(roots)(*(x[0] for x in roots))
    trees = [tree_lib.init_tree(root, 8, 3) for _ in range(2)]
    rets = torch.tensor([0.3, 1.7, -0.2, 0.9, 0.05])
    for t in trees:
        node = torch.tensor(0)
        for act in (2, 0, 1):
            _, node, _ = tree_lib.reserve_child(t, node, torch.tensor(act))
            t.R[node] = 0.1 * (act + 1)
        tree_lib.backprop_update(t, node, torch.tensor(0.4), 0.95)
    _backup_each(trees[0], node.reshape(1), rets, 0.95)
    for r in rets:
        tree_lib.backprop_update(trees[1], node, r, 0.95)
    assert torch.equal(trees[0].N, trees[1].N) and torch.equal(trees[0].V, trees[1].V)
