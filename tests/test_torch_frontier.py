"""The port's frontier-speculative evaluators.

Against the JAX package: ``decode_frontier`` (logits and each candidate's
K/V) matches within rtol = 1e-5, atol = 1e-6 on the reduced llama (vocab
64, 2 layers, float32; parameters carried across with
``params_from_numpy``), and a frontier search chooses the reference's
action on at least 7 of 8 trees (float32 near-ties may flip one).

Inside the port, as ``tests/test_frontier_evaluator.py`` pins the
reference: frontier searches make the cached searches' decisions (dense
and paged, single root and batched; integer fields exactly, ``root_v``
within the reference test's 2e-4), refills onto the snapshot parent or
any candidate child hit the frontier cache with no model call and restore
the logits and K/V of a fresh prefill, a divergent refill invalidates the
snapshot, masked rows never hit, and the engine counts the hits per tree.
The evaluators update their aux in place, so the tests clone an aux they
reuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import FrontierModelEvaluator as JaxFrontier
from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import decode_frontier as jax_decode_frontier
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_ragged as jax_prefill_ragged
from repro_torch import convert, rng
from repro_torch.configs import get_reduced
from repro_torch.core import (
    BatchedAsyncEngine,
    CachedModelEvaluator,
    FrontierModelEvaluator,
    PagedCachedModelEvaluator,
    PagedFrontierModelEvaluator,
    SearchSpec,
    build_searcher,
)
from repro_torch.core.evaluators import EXPAND
from repro_torch.envs.base import map_state
from repro_torch.envs.token_env import TokenEnvState, make_token_env
from repro_torch.models import (
    CALLS,
    decode_frontier,
    decode_step,
    init_cache,
    prefill_ragged,
    reset_calls,
)

from test_torch_paged import _clone, _states, assert_conservation

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
SEARCH_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = dict(vocab_size=64, num_layers=2)
K = 4
PAGED = dict(block_size=4, num_blocks=96)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_reduced("llama3-8b", **ARCH)
    cfg = get_reduced("llama3-8b", **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               **(tol or TOL))


def _evaluators(lm, paged=False):
    """(cached, frontier) evaluators, dense or paged."""
    _, _, cfg, p = lm
    kw = dict(top_k=K, eos_token=1)
    if paged:
        return (PagedCachedModelEvaluator(cfg, p, **kw, **PAGED),
                PagedFrontierModelEvaluator(cfg, p, **kw, **PAGED))
    return CachedModelEvaluator(cfg, p, **kw), FrontierModelEvaluator(cfg, p, **kw)


def _expand_tick(ev, state, aux, acts):
    """One EXPAND tick on every row: the frontier snapshot moment."""
    n = state.length.shape[0]
    scfg = SearchSpec(gamma=1.0, max_sim_steps=8).config
    zeros_b = torch.zeros(n, dtype=torch.bool)
    _, aux = ev.tick(scfg, torch.full((n,), EXPAND, dtype=torch.int32),
                     torch.tensor(acts, dtype=torch.int32), state, zeros_b, torch.zeros(n),
                     torch.ones(n), torch.zeros(n, dtype=torch.int32),
                     rng.split(rng.PRNGKey(0), n), aux)
    return aux


def _child(parent: TokenEnvState, tok) -> TokenEnvState:
    idx = torch.arange(parent.length.shape[0])
    tokens = parent.tokens.clone()
    tokens[idx, parent.length.long()] = torch.as_tensor(tok, dtype=tokens.dtype)
    return TokenEnvState(tokens, parent.length + 1, parent.done)


def _snapshot(lm, paged=False, lengths=(5, 7), acts=(0, 1)):
    ev = _evaluators(lm, paged)[1]
    parent = _states(lengths=lengths)
    n = len(lengths)
    aux = _expand_tick(ev, parent, ev.init_aux(parent, (n, 1)), list(acts))
    assert bool(aux["fr"]["valid"].all())
    return ev, parent, aux


def _refill(ev, aux, state, mask=None):
    n = state.length.shape[0]
    mask = torch.ones(n, dtype=torch.bool) if mask is None else mask
    reset_calls()
    return ev.refill_aux(None, _clone(aux), torch.arange(n), state, mask)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def test_decode_frontier_matches_the_reference(lm):
    jcfg, jp, cfg, p = lm
    rs = np.random.default_rng(1)
    toks = rs.integers(2, 60, size=(3, 12)).astype(np.int32)
    lens = np.array([4, 9, 12], np.int32)
    cand = rs.integers(2, 60, size=(3, K)).astype(np.int32)
    at = np.minimum(lens, 11)
    _, jc = jax_prefill_ragged(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                               jax_init_cache(jcfg, 3, 12))
    _, c = prefill_ragged(p, cfg, torch.from_numpy(toks), torch.from_numpy(lens),
                          init_cache(cfg, 3, 12, device="cpu"))
    jlog, jspec = jax_decode_frontier(jp, jcfg, jnp.asarray(cand), dict(jc, len=jnp.asarray(at)))
    reset_calls()
    log, spec = decode_frontier(p, cfg, torch.from_numpy(cand), dict(c, len=torch.from_numpy(at)))
    assert CALLS["decode_frontier"] == 1 and log.shape == (3, K, cfg.vocab_size)
    _close(log, jlog)
    _close(spec["k"], jspec["k"])
    _close(spec["v"], jspec["v"])
    # Candidate j's logits are those of a decode step that feeds it.
    for j in range(K):
        step, _ = decode_step(p, cfg, torch.from_numpy(cand[:, j]),
                              dict(_clone(c), len=torch.from_numpy(at)))
        _close(log[:, j], step)


def test_frontier_search_matches_the_reference(lm):
    jcfg, jp, cfg, p = lm
    prompt = np.array([3, 17, 42, 8], np.int32)
    b = 8
    spec = dict(algo="wu_uct", engine="async", batch=b, num_simulations=8, wave_size=4,
                max_depth=4, max_sim_steps=4, max_width=4, gamma=1.0)
    jenv = jax_make_token_env(jcfg, jp, jnp.asarray(prompt), max_len=12, top_k=K,
                              eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(prompt), max_len=12, top_k=K, eos_token=1)
    kd = np.random.default_rng(6).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    rd = np.random.default_rng(5).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    ref = jax_build_searcher(jenv, JaxSearchSpec(**spec),
                             evaluator=JaxFrontier(jcfg, jp, top_k=K, eos_token=1))(
        jax.vmap(jenv.init)(jnp.asarray(rd)), jnp.asarray(kd))
    reset_calls()
    res = build_searcher(env, SearchSpec(**spec), device="cpu",
                         evaluator=FrontierModelEvaluator(cfg, p, top_k=K, eos_token=1))(
        env.init(convert.keys_from_numpy(rd, device="cpu")),
        convert.keys_from_numpy(kd, device="cpu"))
    assert CALLS["decode_frontier"] > 0
    assert CALLS["decode_frontier"] + CALLS["decode_step"] == int(res.ticks.max())
    same = np.asarray(ref.action) == res.action.numpy()
    for i in np.flatnonzero(~same):
        print(f"tree {i}: reference action {int(ref.action[i])}, port {int(res.action[i])}")
    assert same.sum() >= 7, f"actions agree on {same.sum()} of {b} trees"


# ---------------------------------------------------------------------------
# Search parity inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged,batch", [(False, 0), (False, 3), (True, 0), (True, 2)])
def test_frontier_search_matches_cached_search(lm, paged, batch):
    _, _, cfg, p = lm
    env = make_token_env(cfg, p, torch.tensor([3, 5, 7]), max_len=14, top_k=K, eos_token=1)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=batch, num_simulations=12,
                      wave_size=4, max_depth=5, max_sim_steps=5, max_width=4, gamma=1.0)
    keys = rng.split(rng.PRNGKey(1), max(batch, 1))
    roots = env.init(rng.split(rng.PRNGKey(2), max(batch, 1)))
    if not batch:
        roots, keys = map_state(lambda x: x[0], roots), keys[0]
    cached, frontier = _evaluators(lm, paged)
    res_c = build_searcher(env, spec, evaluator=cached, device="cpu")(roots, keys)
    reset_calls()
    res_f = build_searcher(env, spec, evaluator=frontier, device="cpu")(roots, keys)
    assert CALLS["paged_decode_frontier" if paged else "decode_frontier"] > 0
    for f in ("action", "root_n", "tree_size", "ticks", "overflowed"):
        assert torch.equal(getattr(res_c, f), getattr(res_f, f)), f
    _close(res_f.root_v, res_c.root_v, **SEARCH_TOL)


def test_engine_counts_frontier_hits(lm):
    _, _, cfg, p = lm
    env = make_token_env(cfg, p, torch.tensor([3, 5, 7]), max_len=14, top_k=K, eos_token=1)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=3, num_simulations=12,
                      wave_size=4, max_depth=5, max_sim_steps=5, max_width=4, gamma=1.0)
    roots, keys = env.init(rng.split(rng.PRNGKey(2), 3)), rng.split(rng.PRNGKey(1), 3)
    hits = {}
    for name, ev in zip(("cached", "frontier"), _evaluators(lm)):
        engine = BatchedAsyncEngine(env, spec.config, 3, evaluator=ev)
        carry = engine.init_carry(roots, keys)
        seen = torch.zeros(3, dtype=torch.int64)
        while bool(engine.alive(carry).any()):
            carry, _, _ = engine.run_segment(carry, 2)
            now = engine.frontier_hits(carry)
            assert bool((now >= seen).all()), "the per-tree count must be monotone"
            seen = now
        hits[name] = engine.frontier_hits(carry)
    assert hits["cached"].tolist() == [0, 0, 0]
    assert bool((hits["frontier"] > 0).all()), hits["frontier"]


# ---------------------------------------------------------------------------
# Frontier cache hits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_parent_and_child_refills_hit_frontier_cache(lm, paged):
    """After one EXPAND tick, refills onto the parent and onto each of the
    A candidate children hit: no model call, and the logits (and, for a
    child, the committed K/V row) of a fresh prefill of that path."""
    _, _, cfg, p = lm
    ev, parent, aux = _snapshot(lm, paged)
    n = parent.length.shape[0]
    cand = aux["fr"]["cand"]
    aux_p, hit = _refill(ev, aux, parent)
    assert bool(hit.all()) and sum(CALLS.values()) == 0
    assert torch.equal(aux_p["len"], parent.length)
    _close(aux_p["pol"]["logits"], ev.init_aux(parent, (n, 1))["pol"]["logits"])
    nxt = torch.tensor([21, 23])
    for j in range(K):
        child = _child(parent, cand[:, j])
        aux_c, hit = _refill(ev, aux, child)
        assert bool(hit.all()) and sum(CALLS.values()) == 0, f"child {j}"
        assert torch.equal(aux_c["len"], child.length)
        fresh = ev.init_aux(child, (n, 1))
        _close(aux_c["pol"]["logits"], fresh["pol"]["logits"])
        if paged:
            assert_conservation(ev, aux_c)
        # The committed K/V row is real: one more token from the hit cache
        # decodes as from the fresh prefill.
        fed = torch.ones(n, dtype=torch.bool)
        _close(ev._advance(aux_c, nxt, fed)["pol"]["logits"],
               ev._advance(fresh, nxt, fed)["pol"]["logits"])


def test_divergent_refill_invalidates_frontier(lm):
    ev, parent, aux = _snapshot(lm, lengths=(6, 6), acts=(0, 0))
    divergent = parent.tokens.clone()
    divergent[:, 2] = 61                                 # inside the prefix
    div = TokenEnvState(divergent, parent.length, parent.done)
    aux2, hit = _refill(ev, aux, div)
    assert not bool(hit.any()) and CALLS["decode_chunk"] > 0
    assert not bool(aux2["fr"]["valid"].any())
    aux3, hit = _refill(ev, aux2, parent)                # no stale hit afterwards
    assert not bool(hit.any()) and CALLS["decode_chunk"] > 0
    _close(aux3["pol"]["logits"], ev.init_aux(parent, (2, 1))["pol"]["logits"])


def test_masked_rows_never_hit(lm):
    ev, parent, aux = _snapshot(lm)
    _, hit = _refill(ev, aux, parent, torch.tensor([True, False]))
    assert hit.tolist() == [True, False]
    _, hit = _refill(ev, aux, parent, torch.tensor([False, False]))
    assert hit.tolist() == [False, False]
