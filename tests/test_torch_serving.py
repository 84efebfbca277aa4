"""Host-paced search serving of the port against the JAX package.

The port's :class:`~repro_torch.serving.SearchService` (``fused=False``,
the reference's host-paced poll) and the reference's, over the same tiny
LM (vocab 64, one layer, float32, parameters converted from the
reference's), the same prompts and keys:

* ragged arrival (R = 3 B requests through B = 2 rows), dense and paged:
  equal per-request actions, root visit counts and tick counts; every
  request completes; a paged drain leaves every pool page free;
* mid-run admission into a recycled row equals a fresh one-shot batch;
* ``submit``/``poll``/``drain`` round by round: the same requests finish
  in the same rounds with the same counters;
* refusals: over-long prompts, ``decide``'s out-of-range action (padding
  rows ignored), a wave-engine spec; ``fused=True`` (the default) serves
  the same requests as the host-paced path (``tests/test_torch_ring.py``
  holds it in every evaluator mode);
* the pool-size default (env override, fallback warning, unparseable
  baseline), priority-then-FIFO admission, zero leaked pages after churn;
* the admission helpers against ``repro.serving.admission``;
* the host-paced poll's host reads (settled mask, free pool blocks, the
  harvested results) go through ``repro_torch.sync``, so they are counted.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import SearchSpec as JaxSearchSpec
from repro.models import init_params as jax_init_params
from repro.serving import SearchService as JaxSearchService
from repro.serving import admission as jax_admission
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import SearchSpec
from repro_torch.serving import (
    InvalidSearchActionError,
    PromptTooLongError,
    SearchService,
    admission,
    pack_prompts,
    search_service,
    validate_prompts,
)

torch.set_num_threads(2)

ARCH = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
            head_dim=16, d_ff=64)
PROMPTS = [[3, 5], [2, 9, 4], [7], [1, 2, 3], [5, 5], [6]]
SPEC = dict(algo="wu_uct", engine="async", num_simulations=6, wave_size=2, max_depth=3,
            max_sim_steps=3, max_width=4, gamma=1.0)
SERVICE = dict(top_k=4, max_len=12, eos_token=1, block_size=4, ticks_per_round=4,
               fused=False)


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = dataclasses.replace(jax_get_reduced("llama3-8b"), **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-8b", **ARCH)
    return jcfg, jp, cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                    device="cpu")


def _service(tiny_lm, paged, batch=2, **kw):
    _, _, cfg, p = tiny_lm
    return SearchService(cfg, p, SearchSpec(batch=batch, **SPEC), paged=paged,
                         device="cpu", **{**SERVICE, **kw})


def _jax_service(tiny_lm, paged, batch=2):
    jcfg, jp, _, _ = tiny_lm
    return JaxSearchService(jcfg, jp, JaxSearchSpec(batch=batch, **SPEC), paged=paged,
                            **SERVICE)


def _keys(seed, n):
    return [np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), i)) for i in range(n)]


@pytest.fixture(scope="module")
def reference_rows(tiny_lm):
    """The reference's host-paced results for PROMPTS, dense and paged."""
    keys = _keys(11, len(PROMPTS))
    return {paged: _jax_service(tiny_lm, paged).serve(PROMPTS, keys=[jnp.asarray(k)
                                                                     for k in keys])
            for paged in (False, True)}


def _leaked_pages(svc):
    aux = svc._carry[7]
    return int((aux["refcount"] != 0).sum()), int(aux["oom"]), bool(
        (aux["table"] == svc.evaluator.num_blocks).all())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ragged_arrival_equals_reference(tiny_lm, reference_rows, paged):
    svc = _service(tiny_lm, paged)
    rows = svc.serve(PROMPTS, keys=_keys(11, len(PROMPTS)))
    assert len(rows) == len(PROMPTS)
    for ref, row in zip(reference_rows[paged], rows):
        assert row.action.dim() == 0 and row.root_n.shape == (4,)
        assert int(row.action) == int(ref.action)
        np.testing.assert_array_equal(row.root_n.numpy(), np.asarray(ref.root_n))
        np.testing.assert_allclose(row.root_v.numpy(), np.asarray(ref.root_v), rtol=1e-5,
                                   atol=1e-6)
        assert int(row.ticks) == int(ref.ticks)
    st = svc.stats
    assert st.submitted == st.completed == st.admissions == len(PROMPTS)
    assert st.ticks > 0 and 0.0 <= st.slot_idle_frac < 1.0
    assert st.busy_tree_ticks <= st.ticks * st.batch
    if paged:
        assert _leaked_pages(svc) == (0, 0, True)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mid_run_admission_equals_fresh_batch(tiny_lm, paged):
    """Requests 2 and 3 enter recycled rows mid-run and reach the search a
    fresh one-shot batch with the same keys gives them."""
    keys = _keys(42, 4)
    rows = _service(tiny_lm, paged).serve(PROMPTS[:4], keys=keys)
    oracle = _service(tiny_lm, paged)
    fresh = oracle._search(oracle._roots(PROMPTS[2:4]),
                           torch.from_numpy(np.stack(keys[2:4]).astype(np.int64)))
    for i, b in ((2, 0), (3, 1)):
        assert int(rows[i].action) == int(fresh.action[b])
        np.testing.assert_array_equal(rows[i].root_n.numpy(), fresh.root_n[b].numpy())
        np.testing.assert_array_equal(rows[i].root_v.numpy(), fresh.root_v[b].numpy())


def test_host_paced_reads_are_counted(tiny_lm, monkeypatch):
    """Each host read of a paged host-paced drain goes through the counted
    sync helpers: one settled-mask read per round (and the drain's last
    harvest), the pool's free blocks, and one copy per harvest that frees
    rows."""
    import inspect

    from repro_torch.sync import SYNCS, reset_syncs

    callers = []

    def counted(fn):
        def wrapper(*a, **kw):
            callers.append(inspect.stack()[1].function)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(search_service, "host_read", counted(search_service.host_read))
    monkeypatch.setattr(search_service, "host_copy", counted(search_service.host_copy))
    svc = _service(tiny_lm, True)
    reset_syncs()
    svc.serve(PROMPTS, keys=_keys(11, len(PROMPTS)))
    assert callers.count("_settled") in (svc.stats.host_rounds, svc.stats.host_rounds + 1)
    assert callers.count("_free_pool_blocks") >= 1
    assert callers.count("_harvest") >= len(PROMPTS) // svc.spec.batch
    assert SYNCS["host_any"] >= len(callers)


def test_submit_poll_drain_round_by_round_equals_reference(tiny_lm):
    ref, svc = _jax_service(tiny_lm, False), _service(tiny_lm, False)
    assert [svc.submit(p) for p in PROMPTS[:3]] == [ref.submit(p) for p in PROMPTS[:3]]
    for _ in range(3):
        assert set(svc.poll()) == set(ref.poll())
    more = [svc.submit(p) for p in PROMPTS[3:]]
    assert more == [ref.submit(p) for p in PROMPTS[3:]]
    got, want = svc.drain(), ref.drain()
    assert set(got) == set(want) == set(range(len(PROMPTS)))
    for i in want:
        assert int(got[i].action) == int(want[i].action)
        np.testing.assert_array_equal(got[i].root_n.numpy(), np.asarray(want[i].root_n))
    for f in ("submitted", "completed", "admissions", "ticks", "busy_tree_ticks",
              "host_rounds"):
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f
    assert svc.results.keys() == want.keys()


def test_decide_equals_reference_and_ignores_padding(tiny_lm, monkeypatch):
    jcfg, jp, _, _ = tiny_lm
    ref = _jax_service(tiny_lm, False, batch=3)
    svc = _service(tiny_lm, False, batch=3)
    key = jax.random.PRNGKey(5)
    want, _ = ref.decide(PROMPTS[:2], key)
    got, res = svc.decide(PROMPTS[:2], np.asarray(key))
    assert got == want and res.action.shape == (3,)

    real = svc._search

    def pad_bad(roots, rngs):
        out = real(roots, rngs)
        out.action[-1] = -1
        return out

    monkeypatch.setattr(svc, "_search", pad_bad)
    assert len(svc.decide(PROMPTS[:2], np.asarray(key))[0]) == 2

    def all_bad(roots, rngs):
        out = real(roots, rngs)
        return out._replace(action=torch.full_like(out.action, -1))

    monkeypatch.setattr(svc, "_search", all_bad)
    with pytest.raises(InvalidSearchActionError, match="-1"):
        svc.decide(PROMPTS[:2], np.asarray(key))


def test_refusals(tiny_lm):
    _, _, cfg, p = tiny_lm
    svc = _service(tiny_lm, False)
    with pytest.raises(PromptTooLongError):
        svc.submit(list(range(2, 14)))
    with pytest.raises(PromptTooLongError):
        svc.search([list(range(2, 14))], np.asarray(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="empty"):
        svc.submit([])
    fused = SearchService(cfg, p, SearchSpec(batch=2, **SPEC), device="cpu",
                          **{**SERVICE, "fused": True})
    keys = _keys(11, 3)
    for a, b in zip(fused.serve(PROMPTS[:3], keys=keys), svc.serve(PROMPTS[:3], keys=keys)):
        assert int(a.action) == int(b.action)
        np.testing.assert_array_equal(a.root_n.numpy(), b.root_n.numpy())
    wave = SearchService(cfg, p, SearchSpec(batch=2, **{**SPEC, "engine": "wave"}),
                         device="cpu", **SERVICE)
    wave.submit([3, 5])
    with pytest.raises(ValueError, match="async"):
        wave.drain()


def test_priority_orders_admission(tiny_lm):
    svc = _service(tiny_lm, False, batch=1)
    for i, pri in enumerate([0, 5, 1, 5]):
        svc.submit(PROMPTS[i], priority=pri)
    svc.drain()
    assert list(svc.results) == [1, 3, 2, 0]


def test_paged_churn_leaks_no_pages(tiny_lm):
    """Twice the prompt set through two rows with a pool of 12 blocks (the
    dense bound): every page comes back and no allocation failed."""
    svc = _service(tiny_lm, True, num_blocks=12)
    rows = svc.serve(PROMPTS + PROMPTS)
    assert len(rows) == 2 * len(PROMPTS) == svc.stats.completed
    assert _leaked_pages(svc) == (0, 0, True)
    assert int(svc.evaluator.aux_blocks(svc._carry[7])) == 0


def test_pool_blocks_env_override(tmp_path, monkeypatch):
    base = tmp_path / "BENCH_model_eval.json"
    base.write_text(json.dumps({"rows": [{"kind": "batch_ceiling", "ceiling_ratio": 2.0},
                                         {"kind": "batch_ceiling", "ceiling_ratio": 4.0}]}))
    monkeypatch.setenv(search_service.BENCH_BASELINE_ENV, str(base))
    assert search_service._bench_baseline_path() == base
    # dense = 4 slots * 4 pages = 16; worst ratio 2.0 -> 16 / 2 * 1.25 + 1 = 11.
    assert search_service._prefix_sharing_pool_blocks(4, 32, 8) == 11


def test_pool_blocks_fall_back_with_one_warning(tmp_path, monkeypatch):
    import warnings

    base = tmp_path / "BENCH_model_eval.json"
    base.write_text(json.dumps({"rows": [{"kind": "other"}]}))
    monkeypatch.setenv(search_service.BENCH_BASELINE_ENV, str(base))
    monkeypatch.setattr(search_service, "_pool_fallback_warned", False)
    with pytest.warns(UserWarning, match="batch_ceiling"):
        assert search_service._prefix_sharing_pool_blocks(4, 32, 8) == 16
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert search_service._prefix_sharing_pool_blocks(4, 32, 8) == 16


def test_pool_blocks_unparseable_baseline_warns(tmp_path, monkeypatch):
    base = tmp_path / "BENCH_model_eval.json"
    base.write_text("{not json")
    monkeypatch.setenv(search_service.BENCH_BASELINE_ENV, str(base))
    with pytest.warns(UserWarning, match="could not parse"):
        assert search_service._prefix_sharing_pool_blocks(4, 32, 8) == 16


def test_committed_baseline_sizes_the_pool_as_the_reference():
    from repro.serving import search_service as jax_search_service

    for slots, max_len, bs in ((4, 32, 8), (128, 160, 16)):
        assert search_service._prefix_sharing_pool_blocks(slots, max_len, bs) == \
            jax_search_service._prefix_sharing_pool_blocks(slots, max_len, bs)


# ---------------------------------------------------------------------------
# The admission helpers.
# ---------------------------------------------------------------------------


def test_validate_and_pack_equal_reference():
    prompts = [[3, 5], [2, 9, 4, 7, 1], [7]]
    for pad_to in (None, 4):
        for a, b in zip(pack_prompts(prompts, pad_to),
                        jax_admission.pack_prompts(prompts, pad_to)):
            np.testing.assert_array_equal(a, b)
    validate_prompts(prompts, 6)
    for bad, err in (([[1, 2, 3, 4, 5, 6]], PromptTooLongError), ([[1], []], ValueError)):
        with pytest.raises(err) as got:
            validate_prompts(bad, 6)
        with pytest.raises(ValueError) as want:
            jax_admission.validate_prompts(bad, 6)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
    for n in (0, 1, 4, 5, 16):
        assert admission.pages_needed(n, 4) == jax_admission.pages_needed(n, 4)


def test_splices_equal_reference():
    g = np.random.default_rng(0)
    L, N, S, H, D, P, bs = 2, 6, 8, 1, 4, 7, 4
    cache = {"kv": {"k": g.standard_normal((L, N, S, H, D)).astype(np.float32),
                    "v": g.standard_normal((L, N, S, H, D)).astype(np.float32)},
             "len": np.zeros((), np.int32)}
    new = {"kv": {"k": g.standard_normal((L, 2, S, H, D)).astype(np.float32),
                  "v": g.standard_normal((L, 2, S, H, D)).astype(np.float32)},
           "len": np.zeros((), np.int32)}
    slots = np.asarray([4, 1])
    want = jax_admission.splice_dense_slots(jax.tree.map(jnp.asarray, cache), jnp.asarray(slots),
                                            jax.tree.map(jnp.asarray, new))
    got = admission.splice_dense_slots(jax.tree.map(torch.from_numpy, cache),
                                       torch.from_numpy(slots), jax.tree.map(torch.from_numpy, new))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got["kv"][name].numpy(), np.asarray(want["kv"][name]))

    pools = [g.standard_normal((L, P, bs, H, D)).astype(np.float32) for _ in range(2)]
    dense = [g.standard_normal((L, 2, 2 * bs, H, D)).astype(np.float32) for _ in range(2)]
    dst = np.asarray([[3, P], [0, 5]], np.int32)      # the sentinel P writes nothing
    want = jax_admission.splice_pool_pages(*map(jnp.asarray, pools + dense), jnp.asarray(dst))
    got = admission.splice_pool_pages(*map(torch.from_numpy, pools + dense),
                                      torch.from_numpy(dst))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
