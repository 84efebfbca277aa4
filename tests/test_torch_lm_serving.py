"""LM serving and the recurrent decode cache of the port against the JAX
package.

Parameters come from ``repro.models.init_params`` and are carried across
with ``repro_torch.convert.params_from_numpy``; inputs are made with numpy
from a seed.  Everything runs in float32 on the CPU, where ``ssd_scan``
runs its plain version.

* :class:`~repro_torch.serving.ServingEngine` against the reference's on
  reduced llama3-8b (dense and paged), mamba2-2.7b and zamba2-7b: the same
  tokens for every request, greedy and at temperature 0.7 with the same
  key per tick; pool exhaustion raises at the same tick;
* ``prefill`` plus three ``decode_step``\\ s against the reference's, and
  against the cache-free ``forward``: 1e-4, the reference's own bar
  (``tests/test_arch_smoke.py``);
* ``ssd_scan(return_state=True)``'s plain version against the port's and
  the JAX package's ``ssd_chunked`` final state: 1e-5 (summation order);
  on a CUDA machine the kernel against the plain version (``pytest -m
  cuda``; that test imports no JAX, the others take the JAX package from
  the ``jx`` fixture);
* the ``launch.serve`` launcher with ``--device cpu``, and its refusal to
  run on the CPU unasked;
* host syncs: one per ``ServingEngine`` tick, dense and paged (the tokens,
  and the pool's exhaustion count with them);
* bfloat16 sampling: a sampled serving tick and the evaluators' rollout
  ranks over the same bfloat16 logits draw the reference's tokens exactly.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert, rng
from repro_torch.configs import get_reduced
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    PagePoolExhaustedError,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models import ssm
from repro_torch.serving import ServeConfig, ServingEngine

torch.set_num_threads(2)

VOCAB = 64
ARCHS = ("llama3-8b", "mamba2-2.7b", "zamba2-7b")
TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# (b, s, h, p, n, chunk): one chunk, several, and ssd_chunked's padding of
# a sequence its chunk does not divide (S = 20, 37 and 5 with Q = 16).
STATE_SHAPES = [(2, 64, 4, 16, 16, 16), (1, 128, 3, 32, 16, 128), (2, 20, 4, 16, 16, 16),
                (1, 37, 2, 16, 8, 16), (2, 5, 3, 8, 8, 16)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    from repro import configs, models
    from repro.models import ssm as jax_ssm
    from repro.serving import ServeConfig as JaxServeConfig
    from repro.serving import ServingEngine as JaxServingEngine

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, get_reduced=configs.get_reduced,
                                 models=models, ssm=jax_ssm, ServeConfig=JaxServeConfig,
                                 ServingEngine=JaxServingEngine)


_MODELS = {}


def _model(jx, arch):
    """(reference cfg, reference params, port cfg, port params), float32."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jx.get_reduced(arch), vocab_size=VOCAB)
        jp = jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0))
        cfg = get_reduced(arch, vocab_size=VOCAB)
        _MODELS[arch] = (jcfg, jp, cfg, convert.params_from_numpy(
            jx.jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[arch]


def _prompts(seed, lengths):
    g = np.random.default_rng(seed)
    return [g.integers(2, VOCAB, size=n).tolist() for n in lengths]


def _ssd_inputs(seed, b, s, h, p, n):
    """The JAX tests' distributions: xdt, B, C ~ 0.3 N(0, 1), dA = -softplus(N(0, 1))."""
    rs = np.random.default_rng(seed)
    xdt = (rs.normal(size=(b, s, h, p)) * 0.3).astype(np.float32)
    dA = (-np.logaddexp(rs.normal(size=(b, s, h)), 0.0)).astype(np.float32)
    bm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    return xdt, dA, bm, cm


def _reference_run(jx, engine, prompts, max_ticks, key=None):
    """The reference's ``ServingEngine.run`` with tick ``t`` sampled from
    ``fold_in(key, t)`` when a key is given (its ``run`` takes none)."""
    pending = list(enumerate(prompts))
    slot_to_req, results, ticks = {}, {}, 0
    while (pending or engine.active.any()) and ticks < max_ticks:
        if pending:
            slots = engine.add_requests([p for _, p in pending])
            n = 0
            for (req, _), slot in zip(pending, slots):
                if slot is None:
                    break
                slot_to_req[slot] = req
                n += 1
            pending = pending[n:]
        before = engine.active.copy()
        engine.step(None if key is None else jx.jax.random.fold_in(key, ticks))
        ticks += 1
        for slot in np.flatnonzero(before & ~engine.active):
            results[slot_to_req[int(slot)]] = list(engine.outputs[int(slot)])
    for slot, req in slot_to_req.items():
        results.setdefault(req, list(engine.outputs[slot]))
    return [results.get(i, []) for i in range(len(prompts))]


# ---------------------------------------------------------------------------
# ServingEngine
# ---------------------------------------------------------------------------

ENGINES = [("llama3-8b", False), ("llama3-8b", True), ("mamba2-2.7b", False),
           ("zamba2-7b", False)]


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch,paged", ENGINES,
                         ids=["dense", "paged", "mamba2", "zamba2"])
def test_serving_engine_equals_reference(jx, arch, paged, temperature):
    """Five ragged prompts (4-12 tokens) through two slots, EOS 1: every
    request's tokens equal the reference's."""
    jcfg, jp, cfg, p = _model(jx, arch)
    prompts = _prompts(3, (5, 9, 4, 12, 6))
    sc = dict(batch_slots=2, max_len=24, temperature=temperature, eos_token=1, paged=paged,
              block_size=4)
    seed = 7
    want = _reference_run(jx, jx.ServingEngine(jcfg, jp, jx.ServeConfig(**sc)), prompts, 64,
                          key=jx.jax.random.PRNGKey(seed) if temperature else None)
    engine = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu")
    got = engine.run(prompts, max_ticks=64, key=rng.PRNGKey(seed) if temperature else None)
    assert got == want
    assert all(len(o) > 1 for o in got)
    assert not engine.active.any()
    if paged:
        assert engine.blocks_in_use() == 0


def test_paged_pool_exhaustion_matches_reference(jx):
    """A pool of 3 blocks of 4 for two slots: admission takes only what the
    pool holds, and the tick that finds no block raises
    ``PagePoolExhaustedError`` on both sides, at the same tick."""
    jcfg, jp, cfg, p = _model(jx, "llama3-8b")
    prompts = _prompts(5, (7, 6))
    sc = dict(batch_slots=2, max_len=24, eos_token=-1, paged=True, block_size=4,
              num_blocks=3)
    ref = jx.ServingEngine(jcfg, jp, jx.ServeConfig(**sc))
    engine = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu")
    assert engine.add_requests(prompts) == ref.add_requests(prompts) == [0, None]
    assert engine.blocks_in_use() == ref.blocks_in_use() == 2

    def ticks_until_raise(step, error):
        for t in range(20):
            try:
                step()
            except error:
                return t
        return None

    want = ticks_until_raise(ref.step, jx.models.PagePoolExhaustedError)
    assert want is not None
    assert ticks_until_raise(engine.step, PagePoolExhaustedError) == want
    assert engine.outputs[0] == [int(t) for t in ref.outputs[0]]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_max_new_tokens_caps_each_request(paged):
    """The port's ``max_new_tokens``: no request outgrows it, a cap the
    length bound reaches first changes nothing, and every page comes back."""
    cfg = get_reduced("llama3-8b", vocab_size=VOCAB)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _prompts(4, (5, 9, 4, 12, 6))
    sc = dict(batch_slots=2, max_len=24, eos_token=-1, paged=paged, block_size=4)
    free = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu").run(prompts)
    capped = ServingEngine(cfg, p, ServeConfig(**sc, max_new_tokens=4), device="cpu")
    out = capped.run(prompts)
    assert [len(o) for o in out] == [4] * 5 and [o[:4] for o in free] == out
    assert ServingEngine(cfg, p, ServeConfig(**sc, max_new_tokens=100),
                         device="cpu").run(prompts) == free
    if paged:
        assert capped.blocks_in_use() == 0


def test_serving_engine_refuses_paged_recurrent_and_long_prompts():
    cfg = get_reduced("mamba2-2.7b", vocab_size=VOCAB)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="KV-cache family"):
        ServingEngine(cfg, p, ServeConfig(paged=True), device="cpu")
    engine = ServingEngine(cfg, p, ServeConfig(batch_slots=1, max_len=8), device="cpu")
    from repro_torch.serving import PromptTooLongError

    with pytest.raises(PromptTooLongError):
        engine.add_requests([list(range(2, 10))])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_engine_syncs_once_per_tick(paged):
    """Every tick reads the host once: the tokens, with the paged pool's
    exhaustion count in the same read."""
    from repro_torch.sync import SYNCS, reset_syncs

    cfg = get_reduced("llama3-8b", vocab_size=VOCAB)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, p, ServeConfig(batch_slots=2, max_len=24, eos_token=-1,
                                               paged=paged, block_size=4), device="cpu")
    reset_syncs()
    engine.add_requests(_prompts(4, (5, 9)))
    admission = SYNCS["host_any"]
    assert admission == (2 if paged else 1)      # the first tokens (paged: free blocks)
    for tick in range(6):
        reset_syncs()
        engine.step(rng.PRNGKey(tick) if tick % 2 else None)
        assert SYNCS["host_any"] == 1, tick


def test_bf16_sampled_serving_tick_equals_reference(jx, monkeypatch):
    """One sampled tick over the same bfloat16 logits (8 slots x 1000):
    ``logits / temperature`` and the Gumbel draw stay bfloat16 on both
    sides, so the tokens are equal."""
    from repro_torch.serving import engine as engine_mod

    arch = "llama3-8b"
    jcfg = dataclasses.replace(jx.get_reduced(arch), vocab_size=1000, dtype=jx.jnp.bfloat16)
    cfg = get_reduced(arch, vocab_size=1000, dtype=torch.bfloat16)
    logits = np.random.default_rng(21).normal(size=(8, 1000)).astype(np.float32) * 3
    t_logits = torch.from_numpy(logits).to(torch.bfloat16)
    j_logits = jx.jnp.asarray(logits).astype(jx.jnp.bfloat16)
    sc = dict(batch_slots=8, max_len=16, temperature=0.7, eos_token=-1)
    ref = jx.ServingEngine(jcfg, jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                           jx.ServeConfig(**sc))
    engine = ServingEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                           ServeConfig(**sc), device="cpu")
    prompts = _prompts(6, (3,) * 8)
    ref.add_requests(prompts)
    engine.add_requests(prompts)
    ref._decode = lambda params, tokens, cache: (j_logits, cache)
    monkeypatch.setattr(engine_mod, "decode_step", lambda *a: (t_logits, a[-1]))
    for seed in range(4):
        want = ref.step(jx.jax.random.PRNGKey(seed))
        got = engine.step(rng.PRNGKey(seed))
        assert got == {k: int(v) for k, v in want.items()}, seed


def test_bf16_rollout_ranks_equal_reference(jx):
    """The evaluators' simulation ranks over bfloat16 top-K logits (256 rows,
    top 8) with per-row keys: the reference's draws exactly."""
    from repro.core import ModelEvaluator as JaxModel
    from repro.core import SearchSpec as JaxSearchSpec
    from repro.envs.token_env import TokenEnvState as JaxTokenState
    from repro_torch.core import ModelEvaluator, SearchSpec
    from repro_torch.core.evaluators import SIM
    from repro_torch.envs.token_env import TokenEnvState

    n, k, vocab = 256, 8, 64
    g = np.random.default_rng(22)
    logits = (g.normal(size=(n, vocab)) * 2).astype(np.float32)
    kd = g.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    toks = np.zeros((n, 16), np.int32)
    length = np.full((n,), 4, np.int32)
    done = np.zeros((n,), bool)
    zeros_f, ones_f = np.zeros((n,), np.float32), np.ones((n,), np.float32)
    kind = np.full((n,), SIM, np.int32)
    rest = (done, zeros_f, ones_f, np.zeros((n,), np.int32))
    j_pol = jx.jnp.asarray(logits).astype(jx.jnp.bfloat16)
    t_pol = torch.from_numpy(logits).to(torch.bfloat16)
    jev = JaxModel(None, None, top_k=k, eos_token=-1)
    ev = ModelEvaluator(None, None, top_k=k, eos_token=-1)
    _, want = jev._transition(
        JaxSearchSpec(gamma=1.0).config, jx.jnp.asarray(kind), jx.jnp.zeros((n,), jx.jnp.int32),
        JaxTokenState(*map(jx.jnp.asarray, (toks, length, done))),
        *map(jx.jnp.asarray, rest), jx.jnp.asarray(kd), j_pol, j_pol)
    _, got = ev._transition(
        SearchSpec(gamma=1.0).config, torch.from_numpy(kind), torch.zeros((n,), dtype=torch.int32),
        TokenEnvState(*map(torch.from_numpy, (toks, length, done))),
        *map(torch.from_numpy, rest), convert.keys_from_numpy(kd, device="cpu"), t_pol, t_pol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# prefill and the decode caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference_and_forward(jx, arch):
    """``prefill`` of 12 tokens for 2 rows, then 3 ``decode_step``\\ s: the
    logits equal the reference's and the cache-free forward's (1e-4), and
    the recurrent states the reference's."""
    jcfg, jp, cfg, p = _model(jx, arch)
    tokens = np.asarray(_prompts(11, (15, 15)), np.int32)
    full, _ = forward(p, cfg, {"tokens": torch.from_numpy(tokens)})
    cache = init_cache(cfg, 2, 24, device="cpu")
    jcache = jx.models.init_cache(jcfg, 2, 24)
    logits, cache = prefill(p, cfg, {"tokens": torch.from_numpy(tokens[:, :12])}, cache)
    jlogits, jcache = jx.models.prefill(jp, jcfg, {"tokens": jx.jnp.asarray(tokens[:, :12])},
                                        jcache)
    steps = [(logits, jlogits, 11)]
    for t in range(12, 15):
        logits, cache = decode_step(p, cfg, torch.from_numpy(tokens[:, t]), cache)
        jlogits, jcache = jx.models.decode_step(jp, jcfg, jx.jnp.asarray(tokens[:, t]), jcache)
        steps.append((logits, jlogits, t))
    for got, want, t in steps:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        torch.testing.assert_close(got, full[:, t], **TOL)
    assert int(cache["len"]) == int(jcache["len"]) == 15
    if arch != "llama3-8b":
        np.testing.assert_allclose(cache["ssm"]["state"].numpy(),
                                   np.asarray(jcache["ssm"]["state"]), **TOL)
        np.testing.assert_allclose(cache["ssm"]["conv"].numpy(),
                                   np.asarray(jcache["ssm"]["conv"]), **TOL)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_short_prompt_prefill_continues_like_forward(s):
    """A prompt shorter than the conv window (K - 1 = 3 tokens) gets a
    zero-padded window: prefill then decode equals the cache-free forward.
    (The reference slices the window out of the prompt alone, which has the
    wrong shape below 3 tokens; 1 token takes the decode step on both.)"""
    cfg = get_reduced("mamba2-2.7b", vocab_size=VOCAB)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.tensor(_prompts(2, (s + 3,)))
    full, _ = forward(p, cfg, {"tokens": tokens})
    logits, cache = prefill(p, cfg, {"tokens": tokens[:, :s]}, init_cache(cfg, 1, 8,
                                                                           device="cpu"))
    torch.testing.assert_close(logits, full[:, s - 1], **TOL)
    assert cache["ssm"]["conv"].shape[2] == cfg.conv_kernel - 1
    for t in range(s, s + 3):
        logits, cache = decode_step(p, cfg, tokens[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], **TOL)


@pytest.mark.parametrize("shape", STATE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_state_equals_ssd_chunked(jx, shape):
    """The plain ``ssd_scan(return_state=True)`` over ``ssd_chunked``'s
    chunking (padded to a multiple of ``Q``, as ``ssm_block`` pads it)
    against the port's and the JAX package's ``ssd_chunked``."""
    b, s, h, p, n, chunk = shape
    arrays = _ssd_inputs(sum(shape), b, s, h, p, n)
    q = min(chunk, s)
    pad = -s % q
    padded = [np.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2)) for x in arrays]
    y, h_final = ssd_scan(*map(torch.from_numpy, padded), chunk=q, return_state=True)
    assert h_final.shape == (b, h, p, n) and h_final.dtype == torch.float32
    ref_y = ssd_scan_ref(*map(torch.from_numpy, padded), chunk=q)
    assert torch.equal(y, ref_y)
    port_y, port_h = ssm.ssd_chunked(*map(torch.from_numpy, arrays), chunk)
    jax_y, jax_h = jx.ssm.ssd_chunked(*map(jx.jnp.asarray, arrays), chunk)
    torch.testing.assert_close(y[:, :s], port_y, **SCAN_TOL)
    torch.testing.assert_close(h_final, port_h, **SCAN_TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(jax_h), **SCAN_TOL)
    np.testing.assert_allclose(y[:, :s].numpy(), np.asarray(jax_y), **SCAN_TOL)


# float32 on both sides from the same inputs; the kernel sums in another
# order, and with bf16 B/C it carries the split products' ~2^-17 relative
# error (tests/test_torch_ssd_numerics.py): the bar of
# tests/test_torch_ssm.py's kernel test.
CUDA_TOL = dict(rtol=1e-4, atol=1e-4)
CUDA_STATE_SHAPES = STATE_SHAPES[:2] + [
    (1, 128, 80, 64, 128, 128), (1, 128, 112, 64, 64, 128), (2, 512, 4, 64, 128, 256),
    (2, 33, 3, 18, 12, 11), (1, 45, 5, 64, 64, 15)]


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_state_matches_plain_version(bc_dtype):
    """The kernel's final state and output (one and several chunks, mamba2's
    and zamba2's prefill heads) against the plain version's and the
    sequential recurrence's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    for b, s, h, p, n, chunk in CUDA_STATE_SHAPES:
        xdt, dA, bm, cm = (torch.from_numpy(x).cuda() for x in _ssd_inputs(s, b, s, h, p, n))
        bm, cm = bm.to(bc_dtype), cm.to(bc_dtype)
        before = LAUNCHES["ssd_scan"]
        y, h_final = ssd_scan(xdt, dA, bm, cm, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan"] == before + 1
        ref_y, ref_h = ssd_scan_ref(xdt, dA, bm, cm, chunk=chunk, return_state=True)
        torch.testing.assert_close(y, ref_y, **CUDA_TOL)
        torch.testing.assert_close(h_final, ref_h, **CUDA_TOL)
        seq_y, seq_h = ssm.ssd_sequential_ref(xdt, dA, bm, cm)
        torch.testing.assert_close(h_final, seq_h, rtol=2e-4, atol=2e-4)
        assert torch.equal(ssd_scan(xdt, dA, bm, cm, chunk=chunk), y)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu_when_asked(arch, capsys):
    outputs = launch_serve.main(["--arch", arch, "--smoke", "--requests", "3", "--slots",
                                 "2", "--prompt-len", "5", "--max-len", "12",
                                 "--temperature", "0.5", "--device", "cpu"])
    assert len(outputs) == 3 and all(len(o) > 0 for o in outputs)
    out = capsys.readouterr().out
    assert "served 3 requests on 2 slots" in out and "on cpu" in out


def test_serve_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(get_reduced("llama3-8b"), None, ServeConfig())
