"""The port's model families and configurations against the JAX package.

Every architecture of the reference's registry, at the reference's
reduced configs (2 layers, d_model 64, float32): parameters come from
``repro.models.init_params`` and are carried across with
``params_from_numpy``; tokens, patch embeddings (vlm) and frame
embeddings (encdec) are made with numpy from a seed.

* the registry (``list_archs``), each configuration's fields and
  ``param_count``/``active_param_count`` equal the reference's;
* for each of the seven architectures ported with their families (the
  three dense configs, the two MoE configs, the VLM and enc-dec stubs):
  ``forward`` (logits and the MoE router loss), ``prefill`` plus three
  ``decode_step``\\ s and ``init_cache``'s shapes equal the reference's
  (rtol = atol = 1e-5), and the cached steps equal the cache-free
  ``forward`` (1e-4, the reference's own bar in
  ``tests/test_arch_smoke.py``); ``init_params`` has the reference's
  shapes and dtypes, and ``params_from_numpy`` carries bfloat16 parameters
  bit for bit with the MoE router kept in float32;
* ``ServingEngine`` over llava serves text prompts with the reference's
  tokens; over whisper it raises the reference's ``KeyError`` at
  admission (its prefill needs frame embeddings); the launcher takes every
  architecture name;
* the cached evaluators refuse vlm and encdec, as the reference's do;
* on a CUDA machine (``pytest -m cuda``), the decode, paged, tree and
  flash kernels against their plain versions at the new head layouts
  (Hq, Hkv, D): G = 5, 8, 16 at D = 64, and MHA at D = 64 and 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import models as jax_models
from repro.core import CachedModelEvaluator as JaxCached
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import configs, convert
from repro_torch.core import CachedModelEvaluator, PagedCachedModelEvaluator
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.serving import ServeConfig, ServingEngine

from test_torch_lm_serving import _reference_run

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
NEW_ARCHS = ["phi3-medium-14b", "qwen2.5-32b", "deepseek-67b", "qwen2-moe-a2.7b",
             "qwen3-moe-235b-a22b", "llava-next-mistral-7b", "whisper-small"]

_MODELS = {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params), float32."""
    if arch not in _MODELS:
        jcfg = jax_configs.get_reduced(arch)
        jp = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = configs.get_reduced(arch)
        _MODELS[arch] = (jcfg, jp, cfg, convert.params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[arch]


def _batch(cfg, tokens, seed=0):
    """The numpy batch of ``tokens [B, S]`` with the family's frontend
    inputs: ``num_patches`` patch embeddings (vlm), ``encoder_seq`` frame
    embeddings (encdec)."""
    g = np.random.default_rng(seed)
    b = tokens.shape[0]
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = g.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = g.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


# ---------------------------------------------------------------------------
# The registry and the configurations
# ---------------------------------------------------------------------------


def test_registry_equals_the_reference():
    assert configs.list_archs() == jax_configs.list_archs()
    assert configs.ARCHS == jax_configs.ARCHS
    assert configs.ALIASES == jax_configs.ALIASES
    with pytest.raises(KeyError):
        configs.get_config("gpt2")


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_config_and_param_count_equal_the_reference(arch):
    for port, ref in ((configs.get_config(arch), jax_configs.get_config(arch)),
                      (configs.get_reduced(arch), jax_configs.get_reduced(arch))):
        for f in dataclasses.fields(port):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), (arch, f.name)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert configs.get_config(arch).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_equals_the_reference(arch):
    jcfg, jp, cfg, p = _model(arch)
    batch = _batch(cfg, _tokens(1, (2, 10), cfg.vocab_size))
    jlogits, jaux = jax_models.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, aux = forward(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert logits.shape == (2, 10 + extra, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")


def _cached_steps(p, cfg, batch, tokens):
    """Logits of ``prefill`` over the first 7 tokens and of 3
    ``decode_step``\\ s after it, and the cache."""
    pre = dict(batch, tokens=tokens[:, :7])
    cache = init_cache(cfg, 2, 24, device="cpu")
    logits, cache = prefill(p, cfg, {k: torch.from_numpy(v) for k, v in pre.items()}, cache)
    out = [logits]
    for t in range(7, 10):
        logits, cache = decode_step(p, cfg, torch.from_numpy(tokens[:, t]), cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_equal_reference_and_forward(arch):
    """``prefill`` of 7 tokens for 2 rows (behind the patches for vlm, with
    the encoder's cross K/V for encdec), then 3 ``decode_step``\\ s.  An MoE
    call's capacity depends on its token count, so an MoE model equals the
    cache-free ``forward`` only with room for every token
    (``capacity_factor=8.0``, as ``tests/test_arch_smoke.py`` sets it)."""
    jcfg, jp, cfg, p = _model(arch)
    tokens = _tokens(2, (2, 10), cfg.vocab_size)
    batch = _batch(cfg, tokens)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert _shapes(init_cache(cfg, 2, 24, device="cpu")) == _shapes(
        jax_models.init_cache(jcfg, 2, 24))
    got, cache = _cached_steps(p, cfg, batch, tokens)
    pre = dict(batch, tokens=tokens[:, :7])
    jlogits, jcache = jax_models.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in pre.items()},
                                         jax_models.init_cache(jcfg, 2, 24))
    want = [jlogits]
    for t in range(7, 10):
        jlogits, jcache = jax_models.decode_step(jp, jcfg, jnp.asarray(tokens[:, t]), jcache)
        want.append(jlogits)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert int(cache["len"]) == int(jcache["len"]) == extra + 10
    if cfg.family == "encdec":
        np.testing.assert_allclose(cache["cross"]["k"].numpy(),
                                   np.asarray(jcache["cross"]["k"]), **TOL)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        got, _ = _cached_steps(p, cfg, batch, tokens)
    full, _ = forward(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    for logits, t in zip(got, range(6, 10)):
        torch.testing.assert_close(logits, full[:, extra + t], **FORWARD_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_layout_and_bfloat16_round_trip(arch):
    """``init_params`` has the reference's leaves, shapes and dtypes;
    ``params_from_numpy`` carries bfloat16 parameters bit for bit and keeps
    the router's float32 values."""
    jcfg = jax_configs.get_reduced(arch, dtype=jnp.bfloat16)
    cfg = configs.get_reduced(arch, dtype=torch.bfloat16)
    jp = jax_models.init_params(jcfg, jax.random.PRNGKey(1))
    if cfg.family == "moe":
        # Float32 values that bfloat16 would round.
        jp["blocks"]["moe"]["router"] = jp["blocks"]["moe"]["router"] + jnp.float32(1e-4)
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    got = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        x, y = mine, got
        for key in path:
            x, y = x[key.key], y[key.key]
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert tuple(x.shape) == leaf.shape and x.dtype == want, path
        assert y.dtype == want, path
        np.testing.assert_array_equal(y.float().numpy(), np.asarray(leaf, np.float32))
    names = {key.key for path, _ in flat for key in path}
    assert ("router" in names) == (cfg.family == "moe")
    assert ("encoder" in names and "cross" in names) == (cfg.family == "encdec")


# ---------------------------------------------------------------------------
# Serving and the evaluators
# ---------------------------------------------------------------------------


def test_llava_serving_engine_equals_reference():
    """Text prompts through two slots, greedy: the per-prompt prefill (vlm
    is not a KV-cache family) and every tick give the reference's tokens."""
    jcfg, jp, cfg, p = _model("llava-next-mistral-7b")
    g = np.random.default_rng(3)
    prompts = [g.integers(2, cfg.vocab_size, size=n).tolist() for n in (5, 9, 4)]
    sc = dict(batch_slots=2, max_len=16, eos_token=1)
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(**sc))
    engine = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu")
    got = engine.run(prompts, max_ticks=40)
    assert got == _reference_run(None, ref, prompts, 40)


def test_whisper_serving_raises_the_reference_key_error():
    jcfg, jp, cfg, p = _model("whisper-small")
    sc = dict(batch_slots=2, max_len=16, eos_token=1)
    with pytest.raises(KeyError, match="frame_embeds"):
        JaxServingEngine(jcfg, jp, JaxServeConfig(**sc)).add_requests([[3, 4, 5]])
    engine = ServingEngine(cfg, p, ServeConfig(**sc), device="cpu")
    with pytest.raises(KeyError, match="frame_embeds"):
        engine.add_requests([[3, 4, 5]])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-small"])
def test_cached_evaluators_refuse_frontend_families(arch):
    jcfg, jp, cfg, p = _model(arch)
    with pytest.raises(ValueError, match="rollback"):
        JaxCached(jcfg, jp, top_k=4)
    for cls, kw in ((CachedModelEvaluator, {}),
                    (PagedCachedModelEvaluator, dict(block_size=4, num_blocks=16))):
        with pytest.raises(ValueError):
            cls(cfg, p, top_k=4, **kw)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a != "whisper-small"])
def test_serve_launcher_takes_the_new_archs(arch, capsys):
    outputs = launch_serve.main(["--arch", arch, "--smoke", "--requests", "3", "--slots",
                                 "2", "--prompt-len", "5", "--max-len", "12",
                                 "--device", "cpu"])
    assert len(outputs) == 3 and all(len(o) > 0 for o in outputs)
    assert "served 3 requests on 2 slots" in capsys.readouterr().out


def test_serve_launcher_whisper_raises_the_reference_key_error():
    with pytest.raises(KeyError, match="frame_embeds"):
        launch_serve.main(["--arch", "whisper-small", "--smoke", "--requests", "1",
                           "--device", "cpu"])


# ---------------------------------------------------------------------------
# On the card: the kernels at the new head layouts
# ---------------------------------------------------------------------------

# (Hq, Hkv, D) of phi3 (40/10), qwen2.5-32b (40/8: G = 5), deepseek (64/8),
# qwen2-moe (16/16), qwen3-moe (64/4 at D = 64: G = 16) and whisper (12/12
# at D = 64).  The bars are tests/test_torch_attention.py's.
NEW_LAYOUTS = [(40, 10, 128), (40, 8, 128), (64, 8, 128), (16, 16, 128), (64, 4, 64),
               (12, 12, 64)]
CUDA_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5),
            torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", NEW_LAYOUTS, ids=lambda x: "x".join(map(str, x)))
def test_cuda_kernels_match_plain_versions_at_new_layouts(layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        paged_decode_attention,
        paged_decode_attention_ref,
        paged_tree_decode_attention,
        paged_tree_decode_attention_ref,
        tree_decode_attention,
        tree_decode_attention_ref,
    )
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    hq, hkv, d = layout
    gen = torch.Generator(device="cuda").manual_seed(hq * 1000 + hkv * 10 + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    n, s, a, bs = 8, 160, 4, 16
    lens = torch.tensor([0, 1, 7, 33, 100, 159, 160, 64], dtype=torch.int32, device="cuda")
    q, k, v = randn(n, hq, d), randn(n, s, hkv, d), randn(n, s, hkv, d)
    qa, ks, vs = randn(n, a, hq, d), randn(n, a, hkv, d), randn(n, a, hkv, d)
    n_pages = s // bs
    pool_k, pool_v = randn(n * n_pages, bs, hkv, d), randn(n * n_pages, bs, hkv, d)
    table = torch.randperm(n * n_pages, generator=gen, device="cuda").to(
        torch.int32).reshape(n, n_pages)
    checks = [
        ("decode_attention", lambda: decode_attention(q, k, v, lens),
         lambda: decode_attention_ref(q, k, v, lens)),
        ("paged_decode_attention", lambda: paged_decode_attention(q, pool_k, pool_v, table, lens),
         lambda: paged_decode_attention_ref(q, pool_k, pool_v, table, lens)),
        ("tree_decode_attention", lambda: tree_decode_attention(qa, k, v, ks, vs, lens),
         lambda: tree_decode_attention_ref(qa, k, v, ks, vs, lens)),
        ("paged_tree_decode_attention",
         lambda: paged_tree_decode_attention(qa, pool_k, pool_v, table, ks, vs, lens),
         lambda: paged_tree_decode_attention_ref(qa, pool_k, pool_v, table, ks, vs, lens)),
    ]
    qf, kf, vf = randn(2, 70, hq, d), randn(2, 70, hkv, d), randn(2, 70, hkv, d)
    checks.append(("flash_attention", lambda: flash_attention(qf, kf, vf, causal=True),
                   lambda: flash_attention_ref(qf, kf, vf, causal=True)))
    for name, kernel, plain in checks:
        before = LAUNCHES[name]
        out = kernel()
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1, name
        torch.testing.assert_close(out, plain(), **CUDA_TOL[dtype],
                                   msg=lambda m: f"{name} {hq}/{hkv} D={d}: {m}")
