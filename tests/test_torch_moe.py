"""The port's MoE family against the JAX package.

Parameters come from the reference's ``init_moe`` / ``init_params`` and are
carried across (the router in float32); inputs are made with numpy from a
seed.  Everything runs in float32 on the CPU at the reference's reduced
qwen2-moe-a2.7b (4 experts, top 2, shared experts) and qwen3-moe (no shared
experts):

* ``_moe_block_local``: ``out`` and ``aux`` at the default capacity factor
  (tokens dropped), at 8.0 (none dropped), with a zero router (every
  expert ties, so the top-k takes the lower indices, as ``jax.lax.top_k``
  does) and with dead padding experts (``num_experts_real``):
  rtol = atol = 1e-5;
* the cached, paged, frontier and paged-frontier searches at the default
  capacity factor: action and root visit counts exact, root values within
  1e-6 (relative, atol 1e-6) (``SearchService`` over the same model:
  ``tests/test_torch_moe_serving.py``);
* ``ServingEngine`` (dense and paged): the reference's tokens for every
  request.

An MoE layer routes all the tokens of a call together, so each of these
holds the port to the reference's ``[B, S]`` per model call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import CachedModelEvaluator as JaxCached
from repro.core import FrontierModelEvaluator as JaxFrontier
from repro.core import PagedCachedModelEvaluator as JaxPaged
from repro.core import PagedFrontierModelEvaluator as JaxPagedFrontier
from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import (
    CachedModelEvaluator,
    FrontierModelEvaluator,
    PagedCachedModelEvaluator,
    PagedFrontierModelEvaluator,
    SearchSpec,
    build_searcher,
)
from repro_torch.envs.token_env import make_token_env
from repro_torch.models import CALLS, layers, reset_calls
from repro_torch.serving import ServeConfig, ServingEngine

from test_torch_lm_serving import _reference_run

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
VALUE_TOL = dict(rtol=1e-6, atol=1e-6)
MOE = "qwen2-moe-a2.7b"


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _moe_pair(arch, **overrides):
    jcfg = jax_get_reduced(arch, **overrides)
    cfg = get_reduced(arch, **overrides)
    jp = jl.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, jp, cfg, _to_torch(jax.tree.map(np.asarray, jp))


def _moe_both(jcfg, jp, cfg, p, x):
    jout, jaux = jl._moe_block_local(jp, jcfg, jnp.asarray(x))
    out, aux = layers._moe_block_local(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    return out


def _x(seed, b=2, s=8, d=64):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [MOE, "qwen3-moe-235b-a22b"])
def test_moe_block_drops_tokens_as_the_reference(arch):
    """16 tokens x top 2 over 4 experts at capacity factor 1.25 (capacity
    10), every token leaning towards expert 0: it overflows, so the output
    differs from the run with room for every token, and equals the
    reference's in both."""
    jcfg, jp, cfg, p = _moe_pair(arch)
    x = _x(0) + np.sign(np.asarray(jp["router"])[:, 0]).astype(np.float32)
    dropped = _moe_both(jcfg, jp, cfg, p, x)
    roomy = _moe_both(dataclasses.replace(jcfg, capacity_factor=8.0), jp,
                      dataclasses.replace(cfg, capacity_factor=8.0), p, x)
    assert not torch.allclose(dropped, roomy, **TOL)


def test_moe_block_zero_router_ties_to_lower_experts():
    """A zero router gives every expert the same probability: the top 2
    are experts 0 and 1 for every token (lower index first), so both
    overflow at capacity 10 and later tokens drop."""
    jcfg, jp, cfg, p = _moe_pair(MOE)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    _moe_both(jcfg, jp, cfg, p, _x(1))
    _, idx = layers.sorted_top_k(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3


def test_moe_block_masks_dead_experts():
    jcfg, jp, cfg, p = _moe_pair(MOE, num_experts_real=3)
    _moe_both(jcfg, jp, cfg, p, _x(2))
    # The dead expert takes no token: its router column does not matter.
    p2 = dict(p, router=p["router"].clone())
    p2["router"][:, 3] = 100.0
    out, _ = layers._moe_block_local(p2, cfg, torch.from_numpy(_x(2)))
    want, _ = layers._moe_block_local(p, cfg, torch.from_numpy(_x(2)))
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# Searches and serving over reduced qwen2-moe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_lm():
    jcfg = jax_get_reduced(MOE)
    cfg = get_reduced(MOE)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert p["blocks"]["moe"]["router"].dtype == torch.float32
    return jcfg, jp, cfg, p


K = 4
PAGED = dict(block_size=4, num_blocks=96)
EVALUATORS = {
    "cached": (JaxCached, CachedModelEvaluator, {}, "decode_step"),
    "paged": (JaxPaged, PagedCachedModelEvaluator, PAGED, "paged_decode_step"),
    "frontier": (JaxFrontier, FrontierModelEvaluator, {}, "decode_frontier"),
    "paged_frontier": (JaxPagedFrontier, PagedFrontierModelEvaluator, PAGED,
                       "paged_decode_frontier"),
}


@pytest.mark.parametrize("mode", list(EVALUATORS))
def test_moe_search_equals_the_reference(moe_lm, mode):
    """An async wu_uct search over 4 trees with the evaluator of ``mode``:
    action and root visit counts exact, root values within 1e-6."""
    jcfg, jp, cfg, p = moe_lm
    jcls, cls, kw, call = EVALUATORS[mode]
    prompt = np.array([3, 17, 42, 8, 99], np.int32)
    b = 4
    spec = dict(algo="wu_uct", engine="async", batch=b, num_simulations=8, wave_size=4,
                max_depth=4, max_sim_steps=4, max_width=K, gamma=1.0)
    jenv = jax_make_token_env(jcfg, jp, jnp.asarray(prompt), max_len=12, top_k=K,
                              eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(prompt), max_len=12, top_k=K, eos_token=1)
    kd = np.random.default_rng(6).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    rd = np.random.default_rng(5).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    ref = jax_build_searcher(jenv, JaxSearchSpec(**spec),
                             evaluator=jcls(jcfg, jp, top_k=K, eos_token=1, **kw))(
        jax.vmap(jenv.init)(jnp.asarray(rd)), jnp.asarray(kd))
    reset_calls()
    res = build_searcher(env, SearchSpec(**spec), device="cpu",
                         evaluator=cls(cfg, p, top_k=K, eos_token=1, **kw))(
        env.init(convert.keys_from_numpy(rd, device="cpu")),
        convert.keys_from_numpy(kd, device="cpu"))
    assert CALLS[call] > 0
    np.testing.assert_array_equal(res.action.numpy(), np.asarray(ref.action))
    np.testing.assert_array_equal(res.root_n.numpy(), np.asarray(ref.root_n))
    np.testing.assert_allclose(res.root_v.numpy(), np.asarray(ref.root_v), **VALUE_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_serving_engine_equals_reference(moe_lm, paged):
    """Five ragged prompts through two slots, greedy, EOS 1: the batched
    ragged admission and every decode tick route as the reference's."""
    jcfg, jp, cfg, p = moe_lm
    g = np.random.default_rng(3)
    prompts = [g.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 9, 4, 12, 6)]
    sc = dict(batch_slots=2, max_len=24, eos_token=1, paged=paged, block_size=4)
    want = _reference_run(None, JaxServingEngine(jcfg, jp, JaxServeConfig(**sc)), prompts, 64)
    engine = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu")
    assert engine.run(prompts, max_ticks=64) == want
    assert all(len(o) > 1 for o in want)
    if paged:
        assert engine.blocks_in_use() == 0
