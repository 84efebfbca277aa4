"""The port's token environment and model evaluators against the JAX package.

Mirrors ``tests/test_cached_evaluator.py``: the same parameters (carried
across with ``params_from_numpy``), states and keys go through both
packages.  ``apply_token`` and every sampled token must be exact (float32
logits, the same threefry keys, the same top-K tie rule); rewards and
logits agree within rtol = 1e-5, atol = 1e-6 (float32 summation order, as
in ``tests/test_torch_models.py``).
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
from repro.envs.token_env import TokenEnvState as JaxTokenState
from repro.envs.token_env import apply_token as jax_apply_token
from repro.envs.token_env import make_token_env as jax_make_token_env
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import CachedModelEvaluator, ModelEvaluator, SearchSpec
from repro_torch.core.evaluators import EXPAND, FREE, SIM
from repro_torch.envs.token_env import (
    TokenEnvState,
    apply_token,
    make_token_env,
    sorted_top_k,
)
from repro_torch.models import CALLS, reset_calls

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = dict(vocab_size=64, num_layers=2)
K = 4


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_reduced("llama3-8b", **ARCH)
    cfg = get_reduced("llama3-8b", **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _ragged_states(max_len=16, lengths=(3, 5, 9), seed=7):
    rs = np.random.default_rng(seed)
    n = len(lengths)
    toks = rs.integers(2, 60, size=(n, max_len)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    toks = np.where(np.arange(max_len)[None, :] < lengths[:, None], toks, 0).astype(np.int32)
    done = np.zeros((n,), bool)
    return (JaxTokenState(jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(done)),
            TokenEnvState(torch.from_numpy(toks), torch.from_numpy(lengths),
                          torch.from_numpy(done)))


def _keys(seed, n):
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    return jnp.asarray(kd), convert.keys_from_numpy(kd, device="cpu")


def _scfg():
    return JaxSearchSpec(gamma=1.0, max_sim_steps=8).config, SearchSpec(
        gamma=1.0, max_sim_steps=8).config


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _state_equal(j, t):
    for f in TokenEnvState._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Token environment
# ---------------------------------------------------------------------------


def test_apply_token_is_exact():
    jst, st = _ragged_states(max_len=8, lengths=(3, 7, 8, 2))
    done = np.array([False, False, True, False])
    jst = jst._replace(done=jnp.asarray(done))
    st = st._replace(done=torch.from_numpy(done))
    tok = np.array([1, 5, 6, 9], np.int32)
    logp = np.array([-0.5, -1.5, -2.0, -0.25], np.float32)
    jn, jr, jd = jax_apply_token(jst, jnp.asarray(tok), jnp.asarray(logp), 1)
    n, r, d = apply_token(st, torch.from_numpy(tok), torch.from_numpy(logp), 1)
    _state_equal(jn, n)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_sorted_top_k_puts_lower_index_first_among_ties():
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        vals, idx = sorted_top_k(torch.from_numpy(x).to(dtype), 4)
        assert idx.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]
        assert vals.float().tolist()[0] == [2.0, 2.0, 2.0, 0.5]
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_token_env_step_and_policy_match_the_reference(lm):
    jcfg, jp, cfg, p = lm
    prompt = np.array([3, 17, 42, 8], np.int32)
    jenv = jax_make_token_env(jcfg, jp, jnp.asarray(prompt), max_len=12, top_k=K, eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(prompt), max_len=12, top_k=K, eos_token=1)
    j_keys, keys = _keys(0, 5)
    jst = jax.vmap(jenv.init)(j_keys)
    st = env.init(keys)
    _state_equal(jst, st)
    actions = np.array([0, 1, 2, 3, 1], np.int32)
    for step in range(3):
        j_keys, keys = _keys(10 + step, 5)
        np.testing.assert_array_equal(env.policy(keys, st).numpy(),
                                      np.asarray(jax.vmap(jenv.policy)(j_keys, jst)))
        jst, jr, jd = jax.vmap(jenv.step)(jst, jnp.asarray(actions))
        st, r, d = env.step(st, torch.from_numpy(actions))
        _state_equal(jst, st)
        _close(r, jr)
    reset_calls()
    env.step(st, torch.from_numpy(actions))
    assert CALLS["forward"] == 1            # one forward for the whole batch


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


def _tick_args(n, kind=SIM):
    rdone, acc, disc, steps = (np.zeros((n,), bool), np.zeros((n,), np.float32),
                               np.ones((n,), np.float32), np.zeros((n,), np.int32))
    kinds = np.full((n,), kind, np.int32)
    act = np.arange(n, dtype=np.int32) % K
    return ([jnp.asarray(x) for x in (kinds, act)], [jnp.asarray(x) for x in (rdone, acc, disc, steps)],
            [torch.from_numpy(x) for x in (kinds, act)],
            [torch.from_numpy(x) for x in (rdone, acc, disc, steps)])


def _carry(out):
    """``(rollout_done, acc, disc, steps)`` — the next tick's arguments —
    from a tick's ``(state, r, done, acc, disc, steps, rollout_done)``."""
    return [out[6], out[3], out[4], out[5]]


@pytest.mark.parametrize("distinct_reward", [False, True])
def test_model_evaluator_tick_matches_the_reference(lm, distinct_reward):
    jcfg, jp, cfg, p = lm
    rew_kw, j_rew_kw = {}, {}
    if distinct_reward:
        jrp = jax_init_params(jcfg, jax.random.PRNGKey(9))
        rew_kw = dict(reward_params=convert.params_from_numpy(jax.tree.map(np.asarray, jrp),
                                                              cfg, device="cpu"))
        j_rew_kw = dict(reward_params=jrp)
    jev = JaxModel(jcfg, jp, top_k=K, eos_token=1, **j_rew_kw)
    ev = ModelEvaluator(cfg, p, top_k=K, eos_token=1, **rew_kw)
    jscfg, scfg = _scfg()
    jst, st = _ragged_states()
    n = 3
    for kind in (SIM, EXPAND, FREE):
        (jk, ja), jrest, (tk, ta), trest = _tick_args(n, kind)
        j_keys, keys = _keys(kind, n)
        jaux = jev.init_aux(jst, (n,))
        aux = ev.init_aux(st, (n,))
        jout, jaux = jev.tick(jscfg, jk, ja, jst, *jrest, j_keys, jaux)
        out, aux = ev.tick(scfg, tk, ta, st, *trest, keys, aux)
        _state_equal(jout[0], out[0])
        for a, b in zip(jout[1:], out[1:]):
            _close(b.numpy(), a)
        _close(aux["last_logits"].numpy(), jaux["last_logits"])


def test_cached_init_aux_and_tick_chain_match_the_reference(lm):
    jcfg, jp, cfg, p = lm
    jev = JaxCached(jcfg, jp, top_k=K, eos_token=1)
    ev = CachedModelEvaluator(cfg, p, top_k=K, eos_token=1)
    uncached = ModelEvaluator(cfg, p, top_k=K, eos_token=1)
    jscfg, scfg = _scfg()
    jst, st = _ragged_states()
    n = 3
    jaux = jev.init_aux(jst, (n, 1))
    aux = ev.init_aux(st, (n, 1))
    assert aux["tokens"].data_ptr() != st.tokens.data_ptr()   # the pool owns its copy
    _close(aux["pol"]["logits"].numpy(), jaux["pol"]["logits"])
    np.testing.assert_array_equal(aux["len"].numpy(), np.asarray(jaux["len"]))
    (jk, ja), jrest, (tk, ta), trest = _tick_args(n)
    for step in range(4):
        j_keys, keys = _keys(100 + step, n)
        jout, jaux = jev.tick(jscfg, jk, ja, jst, *jrest, j_keys, jaux)
        out, aux = ev.tick(scfg, tk, ta, st, *trest, keys, aux)
        _state_equal(jout[0], out[0])
        _close(out[1].numpy(), jout[1])
        jst, st, jrest, trest = jout[0], out[0], _carry(jout), _carry(out)
        # The stored logits are the reference's and the full forward's.
        live = ~st.done.numpy()
        _close(aux["pol"]["logits"].numpy()[live], np.asarray(jaux["pol"]["logits"])[live])
        full = uncached._position_logits(p, cfg, st.tokens, st.length)
        torch.testing.assert_close(aux["pol"]["logits"][live], full[live], **TOL)
        np.testing.assert_array_equal(aux["len"].numpy()[live], st.length.numpy()[live])


# The largest divergence below is row 2's disjoint path: 5 tokens.
@pytest.mark.parametrize("refill_chunk,expect_calls", [(1, 5), (2, 3), (8, 1)])
def test_refill_rollback_matches_the_reference(lm, refill_chunk, expect_calls):
    """Roll deep caches back onto divergent paths: the result equals the
    reference's refill and a fresh prefill of the new paths, and the
    catch-up runs ceil(max divergence / refill_chunk) chunk calls."""
    jcfg, jp, cfg, p = lm
    jev = JaxCached(jcfg, jp, top_k=K, eos_token=1, refill_chunk=refill_chunk)
    ev = CachedModelEvaluator(cfg, p, top_k=K, eos_token=1, refill_chunk=refill_chunk)
    jscfg, scfg = _scfg()
    jst, st = _ragged_states(lengths=(4, 4, 4, 4))
    n = 4
    jaux, aux = jev.init_aux(jst, (n, 1)), ev.init_aux(st, (n, 1))
    (jk, ja), jrest, (tk, ta), trest = _tick_args(n)
    for step in range(3):
        j_keys, keys = _keys(200 + step, n)
        jout, jaux = jev.tick(jscfg, jk, ja, jst, *jrest, j_keys, jaux)
        out, aux = ev.tick(scfg, tk, ta, st, *trest, keys, aux)
        jst, st, jrest, trest = jout[0], out[0], _carry(jout), _carry(out)
    # Row 0 keeps its first rollout token and diverges after it; row 1
    # rolls back to the prompt; row 2 takes a disjoint path (re-prefill);
    # row 3 is not refilled (masked out).
    new_tokens = st.tokens.numpy().copy()
    new_len = np.array([6, 4, 5, 7], np.int32)
    new_tokens[0, 5], new_tokens[0, 6:] = 63, 0
    new_tokens[1, 4:] = 0
    new_tokens[2] = 0
    new_tokens[2, :5] = [7, 11, 13, 17, 19]
    mask = np.array([True, True, True, False])
    j_new = JaxTokenState(jnp.asarray(new_tokens), jnp.asarray(new_len), jnp.zeros((n,), bool))
    t_new = TokenEnvState(torch.from_numpy(new_tokens), torch.from_numpy(new_len),
                          torch.zeros((n,), dtype=torch.bool))
    old_len = aux["len"].clone()
    jaux2, _ = jev.refill_aux(jscfg, jaux, jnp.arange(n), j_new, jnp.asarray(mask))
    reset_calls()
    aux2, hits = ev.refill_aux(scfg, aux, torch.arange(n), t_new, torch.from_numpy(mask))
    assert CALLS["decode_chunk"] == expect_calls and CALLS["prefill_ragged"] == 0
    assert not bool(hits.any())
    np.testing.assert_array_equal(aux2["len"].numpy(), np.asarray(jaux2["len"]))
    np.testing.assert_array_equal(aux2["len"].numpy(), np.where(mask, new_len, old_len))
    _close(aux2["pol"]["logits"].numpy(), jaux2["pol"]["logits"])
    fresh = ev.init_aux(t_new, (n, 1))
    torch.testing.assert_close(aux2["pol"]["logits"][:3], fresh["pol"]["logits"][:3], **TOL)
    for name in ("k", "v"):
        for row in range(n):
            valid = int(aux2["len"][row])
            _close(aux2["pol"]["cache"]["kv"][name][:, row, :valid].numpy(),
                   np.asarray(jaux2["pol"]["cache"]["kv"][name])[:, row, :valid])


def test_refill_of_no_row_changes_nothing(lm):
    _, _, cfg, p = lm
    ev = CachedModelEvaluator(cfg, p, top_k=K, eos_token=1)
    _, st = _ragged_states()
    aux = ev.init_aux(st, (3, 1))
    before = {k: v.clone() for k, v in aux["pol"]["cache"]["kv"].items()}
    reset_calls()
    aux2, _ = ev.refill_aux(None, aux, torch.arange(3), st, torch.zeros(3, dtype=torch.bool))
    assert sum(CALLS.values()) == 0
    for k in before:
        assert torch.equal(aux2["pol"]["cache"]["kv"][k], before[k])


def test_cached_tick_needs_its_aux(lm):
    _, _, cfg, p = lm
    ev = CachedModelEvaluator(cfg, p, top_k=K, eos_token=1)
    _, st = _ragged_states()
    _, _, (tk, ta), trest = _tick_args(3)
    with pytest.raises(ValueError, match="slot-aux cache"):
        ev.tick(SearchSpec().config, tk, ta, st, *trest, _keys(0, 3)[1])
    with pytest.raises(ValueError, match="refill_chunk"):
        CachedModelEvaluator(cfg, p, top_k=K, refill_chunk=0)
