"""The port's tree walk, ``tree_descend``, against the JAX traversal.

Mid-search trees are grown by the JAX package's batched wave engine (two
waves, then a third selection phase whose expansions stay pending) on the
tap game 6x6 and on the bandit tree, and carried across with
``repro_torch.convert``.  Then:

* the port's ``tree_descend`` on the CPU (its plain version, the lockstep
  loop) must give JAX ``traverse_batched``'s stop nodes with the Pallas
  kernel in interpret mode, for every policy kind;
* a row-at-a-time model of the CUDA kernel, written here (one row walked
  alone to its end: threefry on the row's own words, float32 scores,
  first index of the best score, an early exit), must equal the lockstep
  plain version on the same trees.  It checks the kernel's decomposition
  on the CPU.

Stop nodes are integers, so both comparisons are exact.  Scores go
through float32 ``log``, which can differ between XLA and PyTorch in the
last bit; on these trees no near-tie is flipped by it.  On a CUDA machine
the kernel is held against the plain version on trees the port grows on
the card, bit for bit (that test imports no JAX, so it also runs where
JAX is not installed: ``pytest -m cuda``).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import convert, rng
from repro_torch.core import SearchSpec
from repro_torch.core.batched_search import mid_search_trees, traverse_batched, walk_inputs
from repro_torch.envs import make_bandit_tree, make_tap_game
from repro_torch.kernels.tree_select import tree_descend, tree_descend_ref
from repro_torch.kernels.tree_select.ref import KINDS

torch.set_num_threads(2)

B = 64
CASES = {
    "tap": (dict(num_simulations=64, wave_size=8, max_depth=10, max_width=5,
                 max_sim_steps=5), lambda m: m.make_tap_game(6, 4, goal_count=10,
                                                             step_budget=20)),
    "bandit": (dict(num_simulations=64, wave_size=8, max_depth=6, max_width=4,
                    max_sim_steps=6, gamma=1.0), lambda m: m.make_bandit_tree(6, 4, seed=3)),
}
POLICY = dict(beta=1.3, r_vl=0.7, n_vl=1.5)


def _grown_by(kind):
    # Sequential UCT runs one simulation per wave (W=1), which grows a tree
    # of three nodes in two waves: walk the wu_uct forest by UCT instead.
    return "wu_uct" if kind == "uct" else kind


def _key_data(seed, n=B):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_case(env_name, kind):
    """A JAX mid-search forest and JAX's stop nodes for two key sets, as
    ``(torch tree, [(torch keys, stops)])``."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro import envs as jenvs
    from repro.core import SearchSpec as JaxSearchSpec
    from repro.core import batched_search as jbs
    from repro.core.batched_tree import init_batched_tree

    fields, make = CASES[env_name]
    jax_env = make(jenvs)
    grow = JaxSearchSpec(algo=_grown_by(kind), **fields).config
    grow = grow._replace(policy=grow.policy._replace(**POLICY))
    cfg = JaxSearchSpec(algo=kind, **fields).config
    cfg = cfg._replace(policy=cfg.policy._replace(**POLICY))

    @jax.jit
    def grow_and_walk(roots, rngs, walks):
        tree = init_batched_tree(roots, grow.num_simulations + grow.wave_size + 1,
                                 jax_env.num_actions)
        for _ in range(2):
            rngs, k_sel, k_sim = jbs._split_each(rngs, 3)
            tree, slots, _ = jbs._phase1_select(tree, k_sel, grow, False)
            out = jbs._phase2_work(jax_env, grow, tree, slots, k_sim)
            tree = jbs._phase3_settle(tree, grow, slots, *out)
        rngs, k_sel, _ = jbs._split_each(rngs, 3)
        tree, _, _ = jbs._phase1_select(tree, k_sel, grow, False)
        stops = [jbs.traverse_batched(tree, w, cfg, use_kernel=True) for w in walks]
        return tree, stops

    roots = jax.vmap(jax_env.init)(jnp.asarray(_key_data(0)))
    walks = [_key_data(2), _key_data(3)]
    tree, stops = grow_and_walk(roots, jnp.asarray(_key_data(1)), jnp.asarray(np.stack(walks)))
    tree = convert.tree_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    keys = [convert.keys_from_numpy(w, device="cpu") for w in walks]
    return tree, [(k, np.asarray(s)) for k, s in zip(keys, stops)]


def _port_config(env_name, kind):
    cfg = SearchSpec(algo=kind, **CASES[env_name][0]).config
    return cfg._replace(policy=cfg.policy._replace(**POLICY))


@pytest.mark.parametrize("env_name", sorted(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_tree_descend_matches_jax_traversal(env_name, kind):
    tree, walks = _jax_case(env_name, kind)
    assert bool(tree.pending.any())
    assert bool((tree.O > 0).any()) if kind != "treep" else bool((tree.VL > 0).any())
    cfg = _port_config(env_name, kind)
    tensors, params = walk_inputs(tree, cfg)
    for keys, j_stops in walks:
        stops = tree_descend(*tensors, keys, **params)
        assert stops.dtype == torch.int64 and stops.shape == (B,)
        np.testing.assert_array_equal(stops.numpy(), j_stops)
        np.testing.assert_array_equal(traverse_batched(tree, keys, cfg).numpy(), j_stops)
    # The walks leave the root and stop at several depths.
    depths = tree.depth[torch.arange(B), torch.from_numpy(j_stops.copy())]
    assert int(depths.max()) >= 2 and int(depths.min()) <= 1


# ---------------------------------------------------------------------------
# A row-at-a-time model of the kernel
# ---------------------------------------------------------------------------

_F = np.float32


def _threefry(k0, k1, x0, x1):
    y0, y1 = rng.threefry2x32(*(torch.tensor(w, dtype=torch.int64) for w in (k0, k1, x0, x1)))
    return int(y0), int(y1)


def _log(x):
    # torch's float32 log, as the plain version takes it (one element or a
    # row of them round alike).
    return _F(torch.log(torch.tensor([x], dtype=torch.float32)).item())


def _explore(log_term, denom, beta):
    if not denom > 0:
        return _F(np.inf)
    q = _F(_F(2.0) * log_term) / max(denom, _F(1e-9))
    return _F(beta) * _F(np.sqrt(np.float64(q)))     # correctly rounded, as sqrtf


def _score(kind, n, o, v, vl, lt, beta, r_vl, n_vl):
    if kind == "wu_uct":
        return v + _explore(lt, n + o, beta)
    if kind == "uct":
        return v + _explore(lt, n, beta)
    if kind == "treep":
        return (v - vl) + _explore(lt, n, beta)
    denom = n + o * _F(n_vl)
    v_adj = (n * v - o * _F(r_vl)) / max(denom, _F(1e-9))
    return v_adj + _explore(lt, denom, beta)


def _walk_one_row(children, N, O, V, VL, pending, terminal, depth, key, *, width,
                  max_depth, expand_coin, kind, beta, r_vl, n_vl):
    """One tree walked alone, with the kernel's control flow."""
    k0, k1 = key
    node = 0
    for _ in range(children.shape[0]):
        # split(key, 2) -> next key (0, 0), coin key (0, 1); coin bits x0 ^ x1.
        c0, c1 = _threefry(k0, k1, 0, 1)
        k0, k1 = _threefry(k0, k1, 0, 0)
        h0, h1 = _threefry(c0, c1, 0, 0)
        u = np.uint32(((h0 ^ h1) >> 9) | 0x3F800000).view(np.float32) - _F(1.0)
        coin = u < _F(expand_coin)
        kids = children[node]
        n_tried = int((kids >= 0).sum())
        if (n_tried == 0 or depth[node] >= max_depth or terminal[node]
                or (n_tried < width and coin)):
            break
        np_, op_ = N[node], O[node]
        lt = _log(max(np_, _F(1.0)) if kind in ("uct", "treep") else max(np_ + op_, _F(1.0)))
        best, idx, any_valid = -np.inf, 0, False
        for a, kid in enumerate(kids):
            valid = kid >= 0 and not pending[kid]
            s = (_score(kind, N[kid], O[kid], V[kid], VL[kid], lt, beta, r_vl, n_vl)
                 if valid else _F(-1e30))
            any_valid |= valid
            if a == 0 or s > best:
                best, idx = s, a
        if not any_valid:
            break
        node = int(kids[idx])
    return node


@pytest.mark.parametrize("env_name", sorted(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_row_at_a_time_model_matches_lockstep_plain_version(env_name, kind):
    tree, walks = _jax_case(env_name, kind)
    tensors, params = walk_inputs(tree, _port_config(env_name, kind))
    arrays = [t.numpy() for t in tensors]
    for keys, _ in walks:
        for coin in (0.5, 0.3):     # 0.3 is not a float32: rounded, as the kernel rounds it
            p = dict(params, expand_coin=coin)
            ref = tree_descend_ref(*tensors, keys, **p).numpy()
            model = [_walk_one_row(*(x[b] for x in arrays), keys[b].tolist(), **p)
                     for b in range(B)]
            np.testing.assert_array_equal(np.array(model), ref)


def test_tree_descend_routes_and_refuses():
    tree, walks = _jax_case("bandit", "wu_uct")
    tensors, params = walk_inputs(tree, _port_config("bandit", "wu_uct"))
    with pytest.raises(ValueError, match="unknown policy kind"):
        tree_descend(*tensors, walks[0][0], **dict(params, kind="puct"))
    meta = [t.to("meta") for t in tensors]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tree_descend(*meta, walks[0][0].to("meta"), **params)


def test_launcher_counts_the_traversal_ops():
    """``descend_sweep --count-ops``: on the CPU the traversal is the
    lockstep loop, whose ops (its coins' threefry hashes among them) are
    counted apart."""
    from repro_torch.launch.descend_sweep import count_ops

    spec = SearchSpec(batch=2, num_simulations=8, wave_size=4, max_depth=6, max_width=4,
                      max_sim_steps=6, gamma=1.0)
    c = count_ops(make_bandit_tree(6, 4), spec, torch.device("cpu"))
    assert 0 < c["threefry_outside"] < c["threefry"] < c["total"]
    assert 0 < c["traversal"] < c["total"]
    assert c["threefry"] - c["threefry_outside"] < c["traversal"]   # the coins' hashes lie inside


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_walk_matches_plain_version():
    """On trees the port grows on the card, the kernel's stop nodes equal
    the plain version's bit for bit, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    device = torch.device("cuda", 0)
    envs = {4: make_bandit_tree(6, 4, seed=3),
            36: make_tap_game(6, 4, goal_count=10, step_budget=20)}
    for a, env in envs.items():
        for b in (1, 257, 1024):
            for kind in KINDS:
                spec = SearchSpec(algo=kind, num_simulations=64, wave_size=8,
                                  max_depth=6 if a == 4 else 10, max_width=a if a == 4 else 5,
                                  max_sim_steps=6, **POLICY)
                roots = env.init(rng.split(rng.PRNGKey(b + a, device=device), b))
                tree = mid_search_trees(env, spec._replace(algo=_grown_by(kind)).config,
                                        roots, rng.split(rng.PRNGKey(1, device=device), b),
                                        waves=2)[-1]
                tensors, params = walk_inputs(tree, spec.config)
                for seed in (2, 3):
                    keys = rng.split(rng.PRNGKey(seed, device=device), b)
                    before = LAUNCHES["tree_descend"]
                    stops = tree_descend(*tensors, keys, **params)
                    torch.cuda.synchronize()
                    assert LAUNCHES["tree_descend"] == before + 1
                    ref = tree_descend_ref(*tensors, keys, **params)
                    assert torch.equal(stops, ref), (kind, b, a, seed)
