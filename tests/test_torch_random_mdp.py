"""The port's normal/gamma/Dirichlet draws and random MDP against JAX.

* ``rng.normal``, ``rng.gamma``, ``rng.loggamma`` and ``rng.dirichlet``
  against ``jax.random`` on 10^5 draws.  They follow JAX's float32
  algorithms step for step (XLA's ``erf_inv`` polynomial with fused
  multiply-adds; Marsaglia–Tsang with one key per element); they differ
  only where PyTorch's ``log``/``log1p``/``exp`` round an ulp away from
  XLA's.  The share of bit-equal elements and the largest difference are
  pinned as measured (ROADMAP.md §3); a flipped rejection-loop acceptance
  would redraw an element entirely and break the bound on the largest
  difference.
* ``make_random_mdp``: ``succ`` and ``rewards`` bit-exact, ``probs``
  within the pinned bound; 256 rollouts of 16 steps equal to the
  reference's (states, keys, rewards and done flags); a ``wu_uct``
  search on the MDP equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.envs import make_random_mdp as jax_random_mdp
from repro_torch import convert, rng
from repro_torch.core import SearchSpec, build_searcher
from repro_torch.envs import make_random_mdp
from repro_torch.envs.random_mdp import mdp_tables

torch.set_num_threads(2)

N = 100_000


def _compare(ref, got, relative=False):
    ref, got = np.asarray(ref), got.numpy()
    diff = np.abs(ref - got)
    if relative:
        diff = diff / np.abs(ref)
    return float((ref == got).mean()), float(diff.max())


# (sampler, exact share at least, largest difference at most), measured on
# these keys: normal 0.99035 / 2.38e-7; gamma(0.5) 0.97846 / 1.19e-6
# relative; loggamma(1) 0.90645 / 4.77e-6; loggamma(3) 0.26949 / 7.15e-7
# (log(d) itself is an ulp off, shifting most draws); dirichlet 0.83586 /
# 1.19e-7.
PINNED = {
    "normal": (0.990, 2.4e-7),
    "gamma_0.5": (0.978, 1.2e-6),
    "loggamma_1": (0.906, 4.8e-6),
    "loggamma_3": (0.269, 7.2e-7),
    "dirichlet": (0.835, 1.2e-7),
}


def _draws(name):
    if name == "normal":
        return (jax.random.normal(jax.random.PRNGKey(0), (N,)),
                rng.normal(rng.PRNGKey(0), (N,)), False)
    if name == "gamma_0.5":
        return (jax.random.gamma(jax.random.PRNGKey(1), 0.5, (N,)),
                rng.gamma(rng.PRNGKey(1), 0.5, (N,)), True)
    if name.startswith("loggamma"):
        a = float(name.split("_")[1])
        return (jax.random.loggamma(jax.random.PRNGKey(2), a, (N,)),
                rng.loggamma(rng.PRNGKey(2), a, (N,)), False)
    return (jax.random.dirichlet(jax.random.PRNGKey(3), jnp.ones(4), (N // 4,)),
            rng.dirichlet(rng.PRNGKey(3), torch.ones(4), (N // 4,)), False)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_sampler_matches_jax_within_pinned_bounds(name):
    ref, got, relative = _draws(name)
    assert got.shape == tuple(np.shape(ref)) and got.dtype == torch.float32
    share, worst = _compare(ref, got, relative)
    lo, hi = PINNED[name]
    assert share >= lo, f"{name}: bit-equal share {share} below the pinned {lo}"
    assert worst <= hi, f"{name}: largest difference {worst} above the pinned {hi}"


def test_erf_inv_is_xla_polynomial_not_torch_erfinv():
    """Where ``log1p`` agrees, the polynomial gives XLA's bits; the edges
    map to +-inf."""
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999])
    out = rng.erf_inv(x)
    assert out[0] == -float("inf") and out[1] == float("inf") and out[2] == 0.0
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(out.numpy()[2:], ref[2:], rtol=3e-7)


def test_dirichlet_rows_sum_to_one_and_batch_shapes():
    d = rng.dirichlet(rng.PRNGKey(5), torch.tensor([0.5, 1.0, 2.0]), (7, 3))
    assert d.shape == (7, 3, 3) and bool((d > 0).all())
    torch.testing.assert_close(d.sum(-1), torch.ones(7, 3))


def test_mdp_tables_match_reference():
    succ, probs, rewards = mdp_tables(32, 4, 4, seed=0)
    k_p, k_r, k_succ = jax.random.split(jax.random.PRNGKey(0), 3)
    ref_succ = jax.random.randint(k_succ, (32, 4, 4), 0, 32, jnp.int32)
    ref_probs = jax.random.dirichlet(k_p, jnp.ones((4,)), (32, 4))
    ref_rewards = jax.random.uniform(k_r, (32, 4), jnp.float32)
    np.testing.assert_array_equal(succ.numpy(), np.asarray(ref_succ))
    np.testing.assert_array_equal(rewards.numpy(), np.asarray(ref_rewards))
    share, worst = _compare(ref_probs, probs)
    # Measured: 0.900 of the 512 entries bit-equal, the rest one ulp off.
    assert share >= 0.9 and worst <= 1.2e-7, (share, worst)


def test_rollouts_equal_reference():
    """256 rollouts of 16 steps with the same keys and actions: every
    categorical draw picks the reference's branch (the one-ulp differences
    in ``probs`` never reach a draw's margin here)."""
    env, jax_env = make_random_mdp(horizon=16), jax_random_mdp(horizon=16)
    keys = np.random.default_rng(0).integers(0, 2 ** 32, size=(256, 2), dtype=np.uint32)
    acts = np.random.default_rng(1).integers(0, 4, size=(16, 256))
    j_state = jax.vmap(jax_env.init)(jnp.asarray(keys))
    state = env.init(convert.keys_from_numpy(keys, device="cpu"))
    j_step = jax.jit(jax.vmap(jax_env.step))
    for t in range(16):
        j_state, j_r, j_done = j_step(j_state, jnp.asarray(acts[t], jnp.int32))
        state, r, done = env.step(state, torch.from_numpy(acts[t]))
        for f in ("s", "t", "key", "done"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(j_state, f)), err_msg=f)
        np.testing.assert_array_equal(r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))
    assert bool(state.done.all())
    obs = env.observe(state)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jax.vmap(jax_env.observe)(j_state)))


def test_wu_uct_search_on_the_mdp_equals_reference():
    env, jax_env = make_random_mdp(horizon=16), jax_random_mdp(horizon=16)
    kd = np.random.default_rng(2).integers(0, 2 ** 32, size=(8, 2), dtype=np.uint32)
    rd = np.random.default_rng(3).integers(0, 2 ** 32, size=(8, 2), dtype=np.uint32)
    spec = dict(algo="wu_uct", batch=8, num_simulations=32, wave_size=8, max_depth=8,
                max_sim_steps=16, max_width=4, gamma=0.99)
    j_roots = jax.vmap(jax_env.init)(jnp.asarray(kd))
    ref = jax_build_searcher(jax_env, JaxSearchSpec(use_kernel=False, **spec))(
        j_roots, jnp.asarray(rd))
    res = build_searcher(env, SearchSpec(**spec), device="cpu")(
        convert.state_from_numpy(jax.tree.map(np.asarray, j_roots), device="cpu"),
        convert.keys_from_numpy(rd, device="cpu"))
    for f in ("action", "root_n", "tree_size", "overflowed"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(res.root_v.numpy(), np.asarray(ref.root_v), rtol=1e-6)
