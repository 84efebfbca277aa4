"""The port's dense model stack against the JAX package.

Parameters come from ``repro.models.init_params`` and are carried across
with ``repro_torch.convert.params_from_numpy``; inputs are made with numpy
from a seed.  Everything runs in float32 on
``get_reduced("llama3-8b", vocab_size=64, num_layers=2)``.

Tolerance: rtol = 1e-5 with atol = 1e-6 for values near zero.  Both sides
compute the same float32 expressions; XLA and PyTorch's CPU kernels sum
matrix products in other orders and XLA fuses multiply-adds, which moves
results by a few ulps (measured ~1e-7 on logits of magnitude ~0.5).
Integer results (cache lengths) are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import decode_chunk as jax_decode_chunk
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models import prefill_ragged as jax_prefill_ragged
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import (
    decode_chunk,
    decode_step,
    forward,
    init_cache,
    init_params,
    layers,
    logits_at,
    prefill_ragged,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = dict(vocab_size=64, num_layers=2)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_reduced("llama3-8b", **ARCH)
    cfg = get_reduced("llama3-8b", **ARCH)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_the_reference():
    ref = jax_get_reduced("llama3-8b", **ARCH)
    port = get_reduced("llama3-8b", **ARCH)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.dtype == torch.float32
    full = get_config("llama3-8b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.rope_theta, full.dtype) == (
        32, 4096, 32, 8, 128, 14336, 128256, 5e5, torch.bfloat16)
    from repro.configs import get_config as jax_get_config
    assert full.param_count() == jax_get_config("llama3-8b").param_count()
    assert get_config("qwen2.5-32b").param_count() == jax_get_config(
        "qwen2.5-32b").param_count()
    with pytest.raises(KeyError):
        get_config("gpt2")          # in neither registry


def test_init_params_shapes_and_scale(lm):
    jcfg, jp, cfg, _ = lm
    p = init_params(cfg, torch.Generator().manual_seed(0))
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_ref:
        x = p
        for key in path:
            x = x[key.key]
        assert tuple(x.shape) == leaf.shape and x.dtype == torch.float32, path
    assert abs(float(p["blocks"]["mlp"]["w_up"].std()) - 0.02) < 2e-3
    assert bool((p["final_norm"] == 1).all())
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], p["embed"])


def test_params_from_numpy_carries_bfloat16_bits():
    cfg = get_reduced("llama3-8b", **ARCH, dtype=torch.bfloat16)
    jcfg = jax_get_reduced("llama3-8b", **ARCH, dtype=jnp.bfloat16)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  dataclasses.replace(cfg, vocab_size=65), device="cpu")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope():
    rs = np.random.default_rng(0)
    x = rs.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rs.normal(size=(64,)).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    h = rs.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    for theta in (1e4, 5e5):
        _close(layers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), theta),
               jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), theta))


@pytest.mark.parametrize("q_offset,kv_len", [
    (0, None), (5, 9), (np.array([0, 3, 6]), np.array([4, 7, 12])),
])
def test_chunked_attention_offsets(q_offset, kv_len):
    rs = np.random.default_rng(1)
    q = rs.normal(size=(3, 4, 4, 16)).astype(np.float32)
    k = rs.normal(size=(3, 12, 2, 16)).astype(np.float32)
    v = rs.normal(size=(3, 12, 2, 16)).astype(np.float32)
    for chunk in (5, 12):
        ref = jl.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(q_offset),
            kv_len=None if kv_len is None else jnp.asarray(kv_len), chunk=chunk)
        out = layers.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_offset=torch.as_tensor(q_offset),
            kv_len=None if kv_len is None else torch.as_tensor(kv_len), chunk=chunk)
        _close(out, ref)


def _layer0(jp, p):
    return jax.tree.map(lambda x: x[0], jp["blocks"])["attn"], p["blocks"]["attn"]


def _cache_pair(seed, b, s, hkv=2, d=16):
    rs = np.random.default_rng(seed)
    k = rs.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rs.normal(size=(b, s, hkv, d)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("path", ["none", "scalar_prefill", "scalar_decode",
                                  "row_decode", "ragged_chunk"])
def test_attention_block_cache_paths(lm, path):
    jcfg, jp, cfg, p = lm
    jattn = jax.tree.map(lambda x: x[0], jp["blocks"]["attn"])
    attn = {k: v[0] for k, v in p["blocks"]["attn"].items()}
    b, big_s = 3, 10
    s = {"none": 6, "scalar_prefill": 4, "scalar_decode": 1, "row_decode": 1,
         "ragged_chunk": 4}[path]
    rs = np.random.default_rng(7)
    x = rs.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    start = {"none": None, "scalar_prefill": np.int32(3), "scalar_decode": np.int32(9),
             "row_decode": np.array([0, 5, 9], np.int32),
             # Row 2 writes past the cache end: those positions are dropped.
             "ragged_chunk": np.array([0, 4, 8], np.int32)}[path]
    base = 0 if start is None else start
    pos = (np.asarray(base).reshape(-1, 1) + np.arange(s)[None, :]).astype(np.int32)
    pos = np.array(np.broadcast_to(pos, (b, s)))
    k0, v0 = _cache_pair(8, b, big_s)
    if start is None:
        ref, rcache = jl.attention_block(jattn, jcfg, jnp.asarray(x), jnp.asarray(pos))
        out, cache = layers.attention_block(attn, cfg, torch.from_numpy(x), torch.from_numpy(pos))
        assert rcache is None and cache is None
    else:
        ref, rcache = jl.attention_block(
            jattn, jcfg, jnp.asarray(x), jnp.asarray(pos),
            cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0), "len": jnp.asarray(start)})
        kc, vc = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        out, cache = layers.attention_block(
            attn, cfg, torch.from_numpy(x), torch.from_numpy(pos),
            cache={"k": kc, "v": vc, "len": torch.from_numpy(np.asarray(start))})
        assert cache["k"] is kc and cache["v"] is vc          # written in place
        np.testing.assert_array_equal(cache["len"].numpy(), np.asarray(rcache["len"]))
        _close(cache["k"], rcache["k"])
        _close(cache["v"], rcache["v"])
    _close(out, ref)


# ---------------------------------------------------------------------------
# The model functions
# ---------------------------------------------------------------------------


def test_forward_and_logits_at(lm):
    jcfg, jp, cfg, p = lm
    toks = _tokens(0, (3, 12))
    ref, _ = jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    out, aux = forward(p, cfg, {"tokens": torch.from_numpy(toks)})
    _close(out, ref)
    assert float(aux) == 0.0
    at = np.array([0, 5, 11])
    _close(logits_at(p, cfg, torch.from_numpy(toks), torch.from_numpy(at)),
           np.asarray(ref)[np.arange(3), at])


def test_prefill_decode_step_and_chunk_match_the_reference(lm):
    jcfg, jp, cfg, p = lm
    big_s = 12
    toks = _tokens(1, (3, big_s))
    lens = np.array([3, 7, 12], np.int32)
    jlog, jc = jax_prefill_ragged(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                  jax_init_cache(jcfg, 3, big_s))
    log, c = prefill_ragged(p, cfg, torch.from_numpy(toks), torch.from_numpy(lens),
                            init_cache(cfg, 3, big_s, device="cpu"))
    _close(log, jlog)
    np.testing.assert_array_equal(c["len"].numpy(), lens)

    # One decode step per row at its own length (row 2 is full: it writes
    # at S - 1, as the evaluators' garbage-row contract has it).
    tok = np.array([5, 9, 11], np.int32)
    safe = np.minimum(lens, big_s - 1)
    jlog, jc = jax_decode_step(jp, jcfg, jnp.asarray(tok), dict(jc, len=jnp.asarray(safe)))
    log, c = decode_step(p, cfg, torch.from_numpy(tok), dict(c, len=torch.from_numpy(safe)))
    _close(log, jlog)
    np.testing.assert_array_equal(c["len"].numpy(), np.asarray(jc["len"]))

    # A ragged chunk: rows behind, at target, and running past the end.
    chunk = _tokens(2, (3, 4))
    cur = np.array([3, 6, 11], np.int32)
    target = np.array([6, 6, 12], np.int32)
    jlog, jc = jax_decode_chunk(jp, jcfg, jnp.asarray(chunk), jnp.asarray(target),
                                dict(jc, len=jnp.asarray(cur)))
    log, c = decode_chunk(p, cfg, torch.from_numpy(chunk), torch.from_numpy(target),
                          dict(c, len=torch.from_numpy(cur)))
    _close(log[[0, 2]], np.asarray(jlog)[[0, 2]])       # rows that finish
    np.testing.assert_array_equal(c["len"].numpy(), np.asarray(jc["len"]))
    for name in ("k", "v"):
        for row, valid in enumerate(np.asarray(jc["len"])):
            _close(c["kv"][name][:, row, :valid], np.asarray(jc["kv"][name])[:, row, :valid])


def test_decode_step_matches_forward_of_the_extended_rows(lm):
    """A cached decode step gives the logits a full forward gives."""
    _, _, cfg, p = lm
    toks = torch.from_numpy(_tokens(3, (2, 9)))
    lens = torch.tensor([4, 8], dtype=torch.int32)
    _, c = prefill_ragged(p, cfg, toks, lens, init_cache(cfg, 2, 9, device="cpu"))
    nxt = torch.tensor([7, 3])
    log, c = decode_step(p, cfg, nxt, c)
    ext = toks.clone()
    ext[0, 4], ext[1, 8] = 7, 3
    full = logits_at(p, cfg, ext, torch.tensor([4, 8]))
    torch.testing.assert_close(log, full, rtol=1e-5, atol=1e-6)
