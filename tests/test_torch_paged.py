"""The port's paged KV cache and ``PagedCachedModelEvaluator``.

Against the JAX package (parameters carried across with
``params_from_numpy``, inputs made with numpy from a seed):

* ``alloc_blocks`` and ``release_pages`` equal the reference's exactly,
  shared pages (duplicate indices) included, over random refcounts, needs
  and tables (a hypothesis property);
* ``paged_decode_step`` (logits and the written pools) and
  ``paged_decode_frontier`` (logits and the candidates' K/V) match within
  rtol = 1e-5, atol = 1e-6 on the reduced llama (vocab 64, 2 layers,
  float32), the tolerance of ``tests/test_torch_models.py``;
* a paged model-guided search chooses the reference's action on at least
  7 of 8 trees (float32 near-ties may flip one, as in
  ``tests/test_torch_async.py``).

Inside the port, as ``tests/test_paged_evaluator.py`` pins the reference:
paged logits equal the dense evaluator's, refcounts equal the live table
entries after every step, copy-on-write isolates siblings, an undersized
pool raises, and a paged search equals the dense cached search (integer
fields exactly, ``root_v`` within the reference test's 2e-4).  The
evaluator updates its aux in place, so the tests clone an aux they reuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import PagedCachedModelEvaluator as JaxPaged
from repro.core import SearchSpec as JaxSearchSpec
from repro.core import build_searcher as jax_build_searcher
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import init_params as jax_init_params
from repro.models import paged as jax_paged
from repro_torch import convert, rng
from repro_torch.configs import get_reduced
from repro_torch.core import (
    CachedModelEvaluator,
    PagedCachedModelEvaluator,
    SearchSpec,
    build_searcher,
)
from repro_torch.core.evaluators import SIM
from repro_torch.envs.token_env import TokenEnvState, make_token_env
from repro_torch.models import (
    CALLS,
    PagePoolExhaustedError,
    alloc_blocks,
    paged_decode_frontier,
    paged_decode_step,
    release_pages,
    reset_calls,
)
from repro_torch.models.layers import put_where_

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
SEARCH_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = dict(vocab_size=64, num_layers=2)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_reduced("llama3-8b", **ARCH)
    cfg = get_reduced("llama3-8b", **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _states(max_len=16, lengths=(3, 5, 9), seed=7) -> TokenEnvState:
    rs = np.random.default_rng(seed)
    toks = rs.integers(2, 60, size=(len(lengths), max_len)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    toks = np.where(np.arange(max_len)[None, :] < lengths[:, None], toks, 0)
    return TokenEnvState(torch.from_numpy(toks.astype(np.int32)), torch.from_numpy(lengths),
                         torch.zeros(len(lengths), dtype=torch.bool))


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def _pair(lm, block_size=4, num_blocks=64):
    _, _, cfg, p = lm
    return (CachedModelEvaluator(cfg, p, top_k=4, eos_token=1),
            PagedCachedModelEvaluator(cfg, p, top_k=4, eos_token=1, block_size=block_size,
                                      num_blocks=num_blocks))


def assert_conservation(ev, aux):
    """refcount[p] == live table entries pointing at p, with multiplicity."""
    rc, tab, lens = aux["refcount"].numpy(), aux["table"].numpy(), aux["len"].numpy()
    live = np.zeros(ev.num_blocks, np.int64)
    for i in range(tab.shape[0]):
        for pi in range(-(-int(lens[i]) // ev.block_size)):
            assert tab[i, pi] < ev.num_blocks, f"slot {i} page {pi}: live entry is garbage"
            live[tab[i, pi]] += 1
    np.testing.assert_array_equal(rc, live)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# Allocator and the masked write against the reference
# ---------------------------------------------------------------------------


def _check_allocator(refcount, need, table, lo, hi):
    blocks, rc, failed = alloc_blocks(torch.from_numpy(refcount), torch.from_numpy(need))
    j_blocks, j_rc, j_failed = jax_paged.alloc_blocks(jnp.asarray(refcount),
                                                      jnp.asarray(need))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(j_blocks))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(j_rc))
    assert int(failed) == int(j_failed)
    released = release_pages(torch.from_numpy(rc.numpy()), torch.from_numpy(table),
                             torch.from_numpy(lo), torch.from_numpy(hi))
    j_released = jax_paged.release_pages(j_rc, jnp.asarray(table), jnp.asarray(lo),
                                         jnp.asarray(hi))
    np.testing.assert_array_equal(released.numpy(), np.asarray(j_released))


def test_allocator_matches_the_reference_with_shared_pages():
    """A deterministic case: rows share pages (duplicate releases), one
    table entry is the sentinel, the pool runs out for the last row."""
    refcount = np.array([2, 0, 1, 0, 3, 0], np.int32)
    need = np.array([True, False, True, True, True])
    table = np.array([[0, 4, 6], [0, 4, 2], [4, 4, 0]], np.int32)
    _check_allocator(refcount, need, table, np.array([0, 1, 0], np.int32),
                     np.array([2, 3, 3], np.int32))


def test_allocator_matches_the_reference_property():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=25, deadline=None, database=None)
    @hyp.given(st.data())
    def check(data):
        p, n, r, mp = 12, 6, 4, 3
        refcount = np.array(data.draw(st.lists(st.integers(0, 3), min_size=p, max_size=p)),
                            np.int32)
        need = np.array(data.draw(st.lists(st.booleans(), min_size=n, max_size=n)))
        table = np.array(data.draw(st.lists(st.integers(0, p), min_size=r * mp,
                                            max_size=r * mp)), np.int32).reshape(r, mp)
        lo = np.array(data.draw(st.lists(st.integers(0, mp), min_size=r, max_size=r)),
                      np.int32)
        hi = np.array(data.draw(st.lists(st.integers(0, mp), min_size=r, max_size=r)),
                      np.int32)
        _check_allocator(refcount, need, table, lo, hi)

    check()


def test_put_where_writes_only_masked_rows():
    """The drop-mode write: rows without the mask write nothing, whatever
    their (possibly out-of-range) index; with no row writing, nothing
    changes."""
    dst = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    vals = -torch.arange(1, 13, dtype=torch.float32).reshape(2, 2, 3)   # [L=2, N=2, 3]
    for mask, index in (([False, True], [9, 1]), ([True, False], [2, 0]),
                        ([False, False], [9, 9])):
        out = dst.clone()
        put_where_(out, (torch.tensor(index),), vals, torch.tensor(mask), lead=1)
        want = dst.clone()
        for i, (m, at) in enumerate(zip(mask, index)):
            if m:
                want[:, at] = vals[:, i]
        assert torch.equal(out, want), (mask, index)


# ---------------------------------------------------------------------------
# Model steps against the reference
# ---------------------------------------------------------------------------


def test_paged_model_steps_match_the_reference(lm):
    jcfg, jp, cfg, p = lm
    rs = np.random.default_rng(3)
    n, bs, n_pages, pool = 4, 4, 3, 10
    shape = (cfg.num_layers, pool, bs, cfg.num_kv_heads, cfg.head_dim)
    pk = rs.normal(size=shape).astype(np.float32)
    pv = rs.normal(size=shape).astype(np.float32)
    table = np.array([[0, 1, pool], [2, 3, 4], [0, 5, 7], [6, 8, pool]], np.int32)
    pos = np.array([5, 9, 4, 6], np.int32)
    # Rows 0-2 write (row 2 at offset 0 of a fresh block); row 3 does not,
    # and attends its 6 cached keys.  (Every row attends something: the
    # XLA oracle would give a row with nothing to attend the mean of V.)
    wb = np.array([1, 4, 5, pool], np.int32)
    wo = pos % bs
    att = pos + (wb < pool)
    token = np.array([5, 9, 11, 13], np.int32)
    jcache = {"k": jnp.asarray(pk), "v": jnp.asarray(pv), "table": jnp.asarray(table),
              "len": jnp.asarray(att), "pos": jnp.asarray(pos),
              "write_block": jnp.asarray(wb), "write_off": jnp.asarray(wo)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    reset_calls()
    jlog, jnew = jax_paged.paged_decode_step(jp, jcfg, jnp.asarray(token), jcache)
    log, new = paged_decode_step(p, cfg, torch.from_numpy(token), cache)
    assert CALLS["paged_decode_step"] == 1
    _close(log, jlog)
    _close(new["k"], jnew["k"])
    _close(new["v"], jnew["v"])

    cand = rs.integers(2, 60, size=(n, 3)).astype(np.int32)
    fcache = dict(jcache, len=jnp.asarray(pos))
    jlog, jspec = jax_paged.paged_decode_frontier(jp, jcfg, jnp.asarray(cand), fcache)
    log, spec = paged_decode_frontier(
        p, cfg, torch.from_numpy(cand),
        {k: torch.from_numpy(np.array(v)) for k, v in fcache.items()})
    assert CALLS["paged_decode_frontier"] == 1
    assert log.shape == (n, 3, cfg.vocab_size)
    _close(log, jlog)
    _close(spec["k"], jspec["k"])
    _close(spec["v"], jspec["v"])


# ---------------------------------------------------------------------------
# The evaluator inside the port
# ---------------------------------------------------------------------------


def test_init_aux_matches_dense(lm):
    dense, paged = _pair(lm)
    state = _states()
    aux_d = dense.init_aux(state, (3, 1))
    aux_p = paged.init_aux(state, (3, 1))
    assert torch.equal(aux_p["len"], aux_d["len"])
    _close(aux_p["pol"]["logits"], aux_d["pol"]["logits"])
    assert_conservation(paged, aux_p)


def _sim_ticks(ev, state, aux, n_ticks, seed=0):
    n = state.length.shape[0]
    scfg = SearchSpec(gamma=1.0, max_sim_steps=8).config
    kind = torch.full((n,), SIM, dtype=torch.int32)
    carry = (torch.zeros(n, dtype=torch.bool), torch.zeros(n), torch.ones(n),
             torch.zeros(n, dtype=torch.int32))
    for step in range(n_ticks):
        keys = rng.split(rng.PRNGKey(seed + step), n)
        (state, r, _, acc, disc, steps, rdone), aux = ev.tick(
            scfg, kind, torch.zeros(n, dtype=torch.int32), state, carry[0], carry[1],
            carry[2], carry[3], keys, aux)
        carry = (rdone, acc, disc, steps)
        yield state, r, aux


def test_tick_chain_matches_dense(lm):
    dense, paged = _pair(lm)
    state = _states()
    chains = zip(_sim_ticks(dense, state, dense.init_aux(state, (3, 1)), 5),
                 _sim_ticks(paged, state, paged.init_aux(state, (3, 1)), 5))
    for step, ((st_d, r_d, aux_d), (st_p, r_p, aux_p)) in enumerate(chains):
        assert torch.equal(st_p.tokens, st_d.tokens), f"step {step}: other tokens"
        _close(r_p, r_d)
        assert torch.equal(aux_p["len"], aux_d["len"])
        _close(aux_p["pol"]["logits"], aux_d["pol"]["logits"])
        assert_conservation(paged, aux_p)


def test_refill_rollback_matches_fresh_prefill_and_releases_pages(lm):
    _, paged = _pair(lm)
    start = _states(lengths=(4, 4, 4))
    n = 3
    for state, _, aux in _sim_ticks(paged, start, paged.init_aux(start, (n, 1)), 5, seed=11):
        pass
    used_before = int(paged.aux_blocks(aux))
    tokens = state.tokens.clone()
    tokens[0, 6:] = 0
    tokens[1, 4:] = 0
    tokens[2] = 0
    tokens[2, :5] = torch.tensor([7, 11, 13, 17, 19])
    new = TokenEnvState(tokens, torch.tensor([6, 4, 5], dtype=torch.int32),
                        torch.zeros(n, dtype=torch.bool))
    aux2, hits = paged.refill_aux(None, aux, torch.arange(n), new,
                                  torch.ones(n, dtype=torch.bool))
    assert not bool(hits.any())
    fresh = paged.init_aux(new, (n, 1))
    assert aux2["len"].tolist() == [6, 4, 5]
    _close(aux2["pol"]["logits"], fresh["pol"]["logits"])
    assert_conservation(paged, aux2)
    assert int(paged.aux_blocks(aux2)) < used_before


def test_refill_skips_masked_rows(lm):
    _, paged = _pair(lm)
    state = _states()
    aux = paged.init_aux(state, (3, 1))
    shallow = TokenEnvState(state.tokens, torch.ones(3, dtype=torch.int32), state.done)
    aux2, _ = paged.refill_aux(None, aux, torch.arange(3), shallow,
                               torch.tensor([False, True, False]))
    assert aux2["len"].tolist() == [3, 1, 9]
    assert_conservation(paged, aux2)


def test_siblings_share_prefix_pages(lm):
    _, paged = _pair(lm)
    aux = paged.init_aux(_states(lengths=(8,), seed=3), (1, 4))   # 1 root x 4 siblings
    tab, rc = aux["table"], aux["refcount"]
    assert torch.equal(tab[0, :2], tab[1, :2]) and torch.equal(tab[0, :2], tab[3, :2])
    assert bool((rc[rc > 0] == 4).all()) and int((rc > 0).sum()) == 2
    assert_conservation(paged, aux)


def test_cow_isolates_diverging_siblings(lm):
    """Two siblings writing different tokens get private pages; logits
    equal the dense evaluator's with separate caches."""
    dense, paged = _pair(lm)
    root = _states(lengths=(8,), seed=3)
    aux_p = paged.init_aux(root, (1, 2))
    aux_d = dense.init_aux(root, (1, 2))
    fed = torch.tensor([True, True])
    for toks in ([5, 9], [7, 7]):
        aux_p = paged._advance(aux_p, torch.tensor(toks), fed)
        aux_d = dense._advance(aux_d, torch.tensor(toks), fed)
        assert int(aux_p["table"][0, 2]) != int(aux_p["table"][1, 2])
        _close(aux_p["pol"]["logits"], aux_d["pol"]["logits"])
        assert_conservation(paged, aux_p)


def test_cow_on_shared_partial_page(lm):
    """A slot writing into a partial page it shares copies the block first;
    the sibling keeps the original."""
    _, paged = _pair(lm)
    aux = paged.init_aux(_states(lengths=(6,), seed=5), (1, 2))   # 1.5 pages of 4
    tab0 = aux["table"].clone()
    before = _clone(aux)
    aux2 = paged._advance(aux, torch.tensor([5, 0]), torch.tensor([True, False]))
    assert int(aux2["table"][0, 1]) != int(tab0[0, 1])
    assert int(aux2["table"][1, 1]) == int(tab0[1, 1])
    assert aux2["len"].tolist() == [7, 6]
    # The shared block itself is untouched by the writer.
    blk = int(tab0[1, 1])
    assert torch.equal(aux2["pol"]["k"][:, blk], before["pol"]["k"][:, blk])
    assert_conservation(paged, aux2)


def test_pool_exhaustion_raises(lm):
    _, _, cfg, p = lm
    tiny = PagedCachedModelEvaluator(cfg, p, top_k=4, eos_token=1, block_size=4,
                                     num_blocks=2)
    with pytest.raises(PagePoolExhaustedError, match="num_blocks=2"):
        tiny.init_aux(_states(), (3, 1))
    aux = tiny.init_aux(_states(lengths=(8,), seed=3), (1, 1))
    tiny.check_exhausted(aux)
    aux = tiny._advance(aux, torch.tensor([5]), torch.tensor([True]))
    with pytest.raises(PagePoolExhaustedError):
        tiny.check_exhausted(aux)


# ---------------------------------------------------------------------------
# Searches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [0, 2])
def test_paged_search_matches_dense_search(lm, batch):
    _, _, cfg, p = lm
    env = make_token_env(cfg, p, torch.tensor([3, 5, 7]), max_len=14, top_k=4, eos_token=1)
    dense, paged = _pair(lm, num_blocks=96)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=batch, num_simulations=10,
                      wave_size=3, max_depth=5, max_sim_steps=5, max_width=4, gamma=1.0)
    if batch:
        roots, keys = env.init(rng.split(rng.PRNGKey(2), batch)), rng.split(rng.PRNGKey(1),
                                                                            batch)
    else:
        roots, keys = env.init(rng.PRNGKey(2)[None]), rng.PRNGKey(2)
        roots = type(roots)(*(x[0] for x in roots))
    res_d = build_searcher(env, spec, evaluator=dense, device="cpu")(roots, keys)
    res_p = build_searcher(env, spec, evaluator=paged, device="cpu")(roots, keys)
    for f in ("action", "root_n", "tree_size", "ticks", "overflowed"):
        assert torch.equal(getattr(res_d, f), getattr(res_p, f)), f
    _close(res_p.root_v, res_d.root_v, **SEARCH_TOL)


def test_paged_search_matches_the_reference(lm):
    jcfg, jp, cfg, p = lm
    prompt = np.array([3, 17, 42, 8], np.int32)
    b, k = 8, 4
    spec = dict(algo="wu_uct", engine="async", batch=b, num_simulations=8, wave_size=4,
                max_depth=4, max_sim_steps=4, max_width=4, gamma=1.0)
    kw = dict(top_k=k, eos_token=1, block_size=4, num_blocks=64)
    jenv = jax_make_token_env(jcfg, jp, jnp.asarray(prompt), max_len=12, top_k=k,
                              eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(prompt), max_len=12, top_k=k, eos_token=1)
    kd = np.random.default_rng(6).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    rd = np.random.default_rng(5).integers(0, 2 ** 32, size=(b, 2), dtype=np.uint32)
    j_roots = jax.vmap(jenv.init)(jnp.asarray(rd))
    roots = env.init(convert.keys_from_numpy(rd, device="cpu"))
    ref = jax_build_searcher(jenv, JaxSearchSpec(**spec), evaluator=JaxPaged(jcfg, jp, **kw))(
        j_roots, jnp.asarray(kd))
    reset_calls()
    res = build_searcher(env, SearchSpec(**spec), evaluator=PagedCachedModelEvaluator(
        cfg, p, **kw), device="cpu")(roots, convert.keys_from_numpy(kd, device="cpu"))
    assert CALLS["paged_decode_step"] == int(res.ticks.max()) and CALLS["decode_step"] == 0
    same = np.asarray(ref.action) == res.action.numpy()
    for i in np.flatnonzero(~same):
        print(f"tree {i}: reference action {int(ref.action[i])}, port {int(res.action[i])}")
    assert same.sum() >= 7, f"actions agree on {same.sum()} of {b} trees"
