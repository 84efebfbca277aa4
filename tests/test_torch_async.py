"""The port's async-slot engine and model-guided search against the JAX package.

* **Bandit tree, four algos**: the port's ``engine="async"`` searches
  (batched, B = 8, and single-root, ``batch=0``) against the reference's
  ``run_async_search_batched`` / ``run_async_search``, with the same roots
  and keys.  Every draw is exact there, so actions, visit counts, tree
  sizes, ticks and ``max_o`` must be equal; values agree within rtol = 1e-6
  (XLA fuses ``a * b + c`` in the value updates, see
  ``tests/test_torch_search.py``).
* **Model-guided search** over the token environment of
  ``get_reduced("llama3-8b", vocab_size=64, num_layers=2)``: the port's
  async search with ``CachedModelEvaluator`` and its wave search with
  ``ModelEvaluator`` against the reference's (``attn_impl="xla"``, the jnp
  path ``tests/test_kernels.py`` holds the Pallas kernels to).  Logits agree
  to float32 rounding only, so a near-tie in the top-K or in a value may
  flip one decision: at least 7 of 8 trees must pick the same action, and
  every divergence is reported.  The port's cached search must also agree
  with its own uncached search on the same trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import CachedModelEvaluator as JaxCached
from repro.core import ModelEvaluator as JaxModel
from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.envs import make_bandit_tree as jax_bandit_tree
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import init_params as jax_init_params
from repro_torch import convert, rng
from repro_torch.configs import get_reduced
from repro_torch.core import (
    BatchedAsyncEngine,
    CachedModelEvaluator,
    ModelEvaluator,
    SearchSpec,
    build_searcher,
)
from repro_torch.envs import make_bandit_tree, make_token_env
from repro_torch.models import CALLS, reset_calls

torch.set_num_threads(2)

ALGOS = ("wu_uct", "uct", "treep", "treep_vc")
B = 8
BANDIT = dict(num_simulations=16, wave_size=4, max_depth=4, max_sim_steps=4,
              max_width=4, gamma=0.9)


def _key_data(seed, n=B):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


def _roots(jax_env, seed, n=B):
    j_roots = jax.vmap(jax_env.init)(jnp.asarray(_key_data(seed, n)))
    return j_roots, convert.state_from_numpy(jax.tree.map(np.asarray, j_roots), device="cpu")


def _assert_results_equal(ref, res):
    for field in ("action", "root_n", "tree_size", "overflowed", "ticks", "max_o",
                  "dup_selections"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    np.testing.assert_allclose(res.root_v.numpy(), np.asarray(ref.root_v), rtol=1e-6)


@pytest.mark.parametrize("algo", ALGOS)
def test_async_bandit_search_is_exact(algo):
    jax_env = jax_bandit_tree(depth=4, num_actions=4, seed=3)
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    j_roots, roots = _roots(jax_env, 0)
    kd = _key_data(1)
    spec = dict(algo=algo, engine="async", use_kernel=False, **BANDIT)
    ref = jax_build_searcher(jax_env, JaxSearchSpec(batch=B, **spec))(j_roots, jnp.asarray(kd))
    res = build_searcher(env, SearchSpec(batch=B, **spec), device="cpu")(
        roots, convert.keys_from_numpy(kd, device="cpu"))
    _assert_results_equal(ref, res)
    assert len(set(np.asarray(ref.ticks).tolist())) > 1    # trees settle at different ticks

    # batch=0 against the reference's single async engine.
    root0 = jax.tree.map(lambda x: x[0], j_roots)
    ref0 = jax_build_searcher(jax_env, JaxSearchSpec(batch=0, **spec))(root0, jnp.asarray(kd[0]))
    res0 = build_searcher(env, SearchSpec(batch=0, **spec), device="cpu")(
        convert.state_from_numpy(jax.tree.map(np.asarray, root0), device="cpu",
                                 cls=type(roots)),
        convert.keys_from_numpy(kd[0], device="cpu"))
    _assert_results_equal(ref0, res0)


def test_engine_runs_in_segments():
    """``run_segment`` in pieces gives ``run``'s result, and settled trees
    stay frozen while the others search on."""
    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    cfg = SearchSpec(engine="async", **BANDIT).config
    roots = env.init(rng.split(rng.PRNGKey(0), 4))
    keys = rng.split(rng.PRNGKey(1), 4)
    engine = BatchedAsyncEngine(env, cfg, 4)
    whole = engine.run(roots, keys)
    carry = engine.init_carry(roots, keys)
    ticks_run, settled_at = 0, {}
    while bool(engine.alive(carry).any()):
        carry, t, busy = engine.run_segment(carry, 3)
        assert 0 < t <= 3 and 0 < busy <= 4 * t
        ticks_run += t
        for b in torch.nonzero(engine.settled(carry)).flatten().tolist():
            settled_at.setdefault(b, (carry[0].size[b].clone(), carry[2][b].clone()))
    assert ticks_run == int(whole.ticks.max())
    for a, b in zip(engine.result(carry), whole):
        assert torch.equal(a, b)
    for b, (size, key) in settled_at.items():       # frozen from their settle on
        assert torch.equal(carry[0].size[b], size) and torch.equal(carry[2][b], key)


# ---------------------------------------------------------------------------
# Model-guided search
# ---------------------------------------------------------------------------

K, MAX_LEN = 4, 12
PROMPT = np.array([3, 17, 42, 8], np.int32)
MODEL_SPEC = dict(algo="wu_uct", batch=B, num_simulations=8, wave_size=4, max_depth=4,
                  max_sim_steps=4, max_width=4, gamma=1.0, use_kernel=False)


@pytest.fixture(scope="module")
def token_search():
    jcfg = jax_get_reduced("llama3-8b", vocab_size=64, num_layers=2)
    cfg = get_reduced("llama3-8b", vocab_size=64, num_layers=2)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jax_env = jax_make_token_env(jcfg, jp, jnp.asarray(PROMPT), max_len=MAX_LEN, top_k=K,
                                 eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(PROMPT), max_len=MAX_LEN, top_k=K,
                         eos_token=1)
    j_roots, roots = _roots(jax_env, 5)
    kd = _key_data(6)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, p=p, jax_env=jax_env, env=env, j_roots=j_roots,
                roots=roots, j_keys=jnp.asarray(kd),
                keys=convert.keys_from_numpy(kd, device="cpu"))


def _agree(ref_action, action, ref_root_n, root_n, what):
    same = ref_action == action
    for i in np.flatnonzero(~same):
        print(f"{what}: tree {i} reference action {ref_action[i]}, port {action[i]} "
              f"(root_n reference {ref_root_n[i].tolist()}, port {root_n[i].tolist()})")
    assert same.sum() >= 7, f"{what}: actions agree on {same.sum()} of {len(same)} trees"


@pytest.mark.parametrize("engine", ["async", "wave"])
def test_model_guided_search_matches_the_reference(token_search, engine):
    t = token_search
    if engine == "async":
        jev = JaxCached(t["jcfg"], t["jp"], top_k=K, eos_token=1)
        ev = CachedModelEvaluator(t["cfg"], t["p"], top_k=K, eos_token=1)
    else:
        jev = JaxModel(t["jcfg"], t["jp"], top_k=K, eos_token=1)
        ev = ModelEvaluator(t["cfg"], t["p"], top_k=K, eos_token=1)
    ref = jax_build_searcher(t["jax_env"], JaxSearchSpec(engine=engine, **MODEL_SPEC),
                             evaluator=jev)(t["j_roots"], t["j_keys"])
    reset_calls()
    res = build_searcher(t["env"], SearchSpec(engine=engine, **MODEL_SPEC), evaluator=ev,
                         device="cpu")(t["roots"], t["keys"])
    _agree(np.asarray(ref.action), res.action.numpy(), np.asarray(ref.root_n),
           res.root_n.numpy(), f"{engine} search")
    assert bool((res.root_n.sum(1) <= MODEL_SPEC["num_simulations"]).all())
    if engine == "async":
        assert CALLS["prefill_ragged"] == 1 and CALLS["forward"] == 0
        assert CALLS["decode_step"] == int(res.ticks.max())   # one per master tick
    else:
        assert CALLS["forward"] > 0 and CALLS["decode_step"] == 0


def test_cached_search_matches_uncached_search(token_search):
    t = token_search
    spec = SearchSpec(engine="async", **MODEL_SPEC)
    cached = build_searcher(t["env"], spec, device="cpu",
                            evaluator=CachedModelEvaluator(t["cfg"], t["p"], top_k=K,
                                                           eos_token=1))(t["roots"], t["keys"])
    plain = build_searcher(t["env"], spec, device="cpu",
                           evaluator=ModelEvaluator(t["cfg"], t["p"], top_k=K,
                                                    eos_token=1))(t["roots"], t["keys"])
    _agree(plain.action.numpy(), cached.action.numpy(), plain.root_n.numpy(),
           cached.root_n.numpy(), "cached vs uncached")
