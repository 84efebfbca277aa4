"""The port's SSM (Mamba-2) and hybrid (Zamba2) families against the JAX package.

Inputs are made with numpy from a seed; parameters come from
``repro.models.init_params`` and are carried across with
``repro_torch.convert.params_from_numpy``.  Everything runs in float32 on
the CPU, where the port's ``ssd_scan`` runs its plain version.

Tolerances (each stated beside its test):

* the plain scan against the Pallas kernel (interpret mode, as
  ``tests/test_kernels.py`` runs it), the same chunking: 1e-5 (atol and
  rtol) for summation order (XLA and PyTorch contract the chunk's products
  in other orders);
* against the O(S) sequential recurrence: 2e-4, the JAX tests' bar (the
  chunked and sequential forms round differently);
* ``ssd_chunked``, ``ssm_block`` and ``forward`` against the reference's
  kernel path (``attn_impl="pallas"``): 1e-5; against its XLA path, which
  pads to ``ssd_chunk`` instead of halving the chunk: 5e-4, the bar of
  ``tests/test_kernel_integration.py``;
* model-guided searches: at least 7 of 8 trees choose the reference's
  action (float32 near-ties in a top-K or a value may flip one).

On a CUDA machine the ``ssd_scan`` kernel is held against its plain
version (``pytest -m cuda``); that test imports no JAX, and the others
take the JAX package from the ``jx`` fixture, so the file also runs where
JAX is not installed.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import CachedModelEvaluator, ModelEvaluator, SearchSpec, build_searcher
from repro_torch.envs import make_token_env
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models import CALLS, decode_step, forward, init_cache, init_params, reset_calls
from repro_torch.models import ssm

torch.set_num_threads(2)

ARCHS = ("mamba2-2.7b", "zamba2-7b")
VOCAB = 64
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
XLA_TOL = dict(rtol=5e-4, atol=5e-4)
# (b, s, h, p, n, chunk): the JAX kernel tests' shapes, an odd single chunk
# and the tiny chunks of the reduced models' S = 20.
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 64),
              (2, 96, 3, 16, 8, 32), (1, 81, 2, 16, 8, 81), (2, 20, 4, 16, 16, 4)]


def _ssd_inputs(seed, b, s, h, p, n):
    """The JAX tests' distributions: xdt, B, C ~ 0.3 N(0, 1), dA = -softplus(N(0, 1))."""
    rs = np.random.default_rng(seed)
    xdt = (rs.normal(size=(b, s, h, p)) * 0.3).astype(np.float32)
    dA = (-np.logaddexp(rs.normal(size=(b, s, h)), 0.0)).astype(np.float32)
    bm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    return xdt, dA, bm, cm


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    from repro import configs, core, models
    from repro.envs import token_env
    from repro.kernels.flash_attention import ops as flash_ops
    from repro.kernels.ssd_scan import ops as ssd_ops
    from repro.kernels.ssd_scan import ref as ssd_ref
    from repro.models import ssm as jax_ssm

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, get_config=configs.get_config,
        get_reduced=configs.get_reduced, ModelEvaluator=core.ModelEvaluator,
        SearchSpec=core.SearchSpec, build_searcher=core.build_searcher,
        make_token_env=token_env.make_token_env, flash_attention=flash_ops.flash_attention,
        ssd_scan=ssd_ops.ssd_scan, ssd_sequential=ssd_ref.ssd_ref_sequential,
        abstract_params=models.abstract_params, forward=models.forward,
        init_params=models.init_params, ssm=jax_ssm)


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def _j(jx, *arrays):
    return [jx.jnp.asarray(x) for x in arrays]


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


# ---------------------------------------------------------------------------
# The scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_pallas_kernel_and_recurrence(jx, shape):
    b, s, h, p, n, chunk = shape
    arrays = _ssd_inputs(sum(shape), b, s, h, p, n)
    out = ssd_scan(*_t(*arrays), chunk=chunk).numpy()        # CPU: the plain version
    assert out.shape == (b, s, h, p) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ssd_scan_ref(*_t(*arrays), chunk=chunk).numpy())
    kernel = np.asarray(jx.ssd_scan(*_j(jx, *arrays), chunk=chunk))
    seq = np.asarray(jx.ssd_sequential(*_j(jx, *arrays)))
    print(f"{shape}: max |plain - Pallas| {_max_err(out, kernel)!r} (bar 1e-5), "
          f"max |plain - sequential| {_max_err(out, seq)!r} (bar 2e-4)")
    np.testing.assert_allclose(out, kernel, **SCAN_TOL)
    np.testing.assert_allclose(out, seq, **SEQ_TOL)


def test_plain_scan_refuses_a_chunk_that_does_not_divide_s():
    arrays = _t(*_ssd_inputs(0, 1, 20, 2, 4, 8))
    with pytest.raises(ValueError, match="does not divide"):
        ssd_scan(*arrays, chunk=8)
    assert ssd_scan(*arrays, chunk=64).shape == (1, 20, 2, 4)   # min(chunk, S) = S


@pytest.mark.parametrize("s,chunk,with_h0", [(64, 16, False), (20, 16, False),
                                             (37, 8, True), (5, 16, True)])
def test_ssd_chunked_matches_the_reference(jx, s, chunk, with_h0):
    """``y`` and ``h_final``, S a multiple of the chunk and not (padded)."""
    b, h, p, n = 2, 3, 8, 16
    arrays = _ssd_inputs(s + chunk, b, s, h, p, n)
    h0 = (np.random.default_rng(s).normal(size=(b, h, p, n)) * 0.3).astype(np.float32)
    th0 = torch.from_numpy(h0) if with_h0 else None
    jh0 = jx.jnp.asarray(h0) if with_h0 else None
    y, hf = ssm.ssd_chunked(*_t(*arrays), chunk, h0=th0)
    jy, jhf = jx.ssm.ssd_chunked(*_j(jx, *arrays), chunk, h0=jh0)
    print(f"S={s} chunk={chunk}: max |y - ref| {_max_err(y, jy)!r}, max |h - ref| "
          f"{_max_err(hf, jhf)!r} (bar 1e-5)")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), **SCAN_TOL)
    sy, shf = ssm.ssd_sequential_ref(*_t(*arrays), h0=th0)
    jsy, jshf = jx.ssm.ssd_sequential_ref(*_j(jx, *arrays), h0=jh0)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), **SCAN_TOL)
    np.testing.assert_allclose(shf.numpy(), np.asarray(jshf), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **SEQ_TOL)


# ---------------------------------------------------------------------------
# Configurations and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(jx, arch):
    for port, ref in ((get_config(arch), jx.get_config(arch)),
                      (get_reduced(arch, vocab_size=VOCAB),
                       jx.get_reduced(arch, vocab_size=VOCAB))):
        for f in dataclasses.fields(port):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), (arch, f.name)
        for prop in ("d_inner", "ssm_heads", "is_attention_free", "supports_long_context"):
            assert getattr(port, prop) == getattr(ref, prop), (arch, prop)
        assert port.param_count() == ref.param_count()
    assert get_config(arch).dtype == torch.bfloat16
    assert get_reduced(arch).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_gives_the_reference_layout(jx, arch):
    """Keys, shapes and dtypes of ``abstract_params`` under a bf16 config,
    with ``A_log``/``dt_bias``/``D`` in float32."""
    cfg = get_reduced(arch, vocab_size=VOCAB, dtype=torch.bfloat16)
    ref = jx.abstract_params(jx.get_reduced(arch, vocab_size=VOCAB, dtype=jx.jnp.bfloat16))
    p = init_params(cfg, torch.Generator().manual_seed(0))
    flat_ref = jx.jax.tree_util.tree_flatten_with_path(ref)[0]

    def count(tree):
        return sum(map(count, tree.values())) if isinstance(tree, dict) else 1

    assert count(p) == len(flat_ref)
    for path, leaf in flat_ref:
        x = p
        for key in path:
            x = x[key.key]
        want = torch.float32 if leaf.dtype == jx.jnp.float32 else torch.bfloat16
        assert tuple(x.shape) == leaf.shape and x.dtype == want, path
    for name in ssm.FLOAT32_LEAVES:
        assert p["blocks"]["ssm"][name].dtype == torch.float32
    assert ("shared_attn" in p) == (arch == "zamba2-7b")


def test_params_from_numpy_keeps_the_float32_leaves(jx):
    arch = "mamba2-2.7b"
    cfg = get_reduced(arch, vocab_size=VOCAB, dtype=torch.bfloat16)
    jp = jx.init_params(jx.get_reduced(arch, vocab_size=VOCAB, dtype=jx.jnp.bfloat16),
                        jx.jax.random.PRNGKey(1))
    # A float32 value that bf16 would round.
    jp["blocks"]["ssm"]["dt_bias"] = jx.jnp.full_like(jp["blocks"]["ssm"]["dt_bias"], 0.1)
    p = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jp), cfg, device="cpu")
    for name in ssm.FLOAT32_LEAVES:
        assert p["blocks"]["ssm"][name].dtype == torch.float32
        np.testing.assert_array_equal(p["blocks"]["ssm"][name].numpy(),
                                      np.asarray(jp["blocks"]["ssm"][name]))
    assert p["blocks"]["ssm"]["in_x"].dtype == torch.bfloat16
    assert p["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(jx, request):
    arch = request.param
    jcfg = jx.get_reduced(arch, vocab_size=VOCAB)
    cfg = get_reduced(arch, vocab_size=VOCAB)
    jp = jx.init_params(jcfg, jx.jax.random.PRNGKey(0))
    # The reference initialises A_log and dt_bias to zeros and D to ones:
    # other values exercise the decay and skip terms.
    rs = np.random.default_rng(3)
    blocks = jp["blocks"]["ssm"]
    for name, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -2.0, 0.5), ("D", 0.5, 1.5)):
        blocks[name] = jx.jnp.asarray(rs.uniform(lo, hi, blocks[name].shape).astype(np.float32))
    p = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, p=p)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


def test_ssm_block_matches_the_reference(jx, model):
    """One block at S = 20 (chunk 16 halves to 4 on the kernel path)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    u = (np.random.default_rng(5).normal(size=(2, 20, cfg.d_model)) * 0.5).astype(np.float32)
    bp = jx.jax.tree.map(lambda x: x[0], model["jp"]["blocks"]["ssm"])
    out, cache = ssm.ssm_block(jx.jax.tree.map(lambda x: torch.from_numpy(np.array(x)), bp),
                               cfg, torch.from_numpy(u))
    assert cache is None
    pallas, _ = jx.ssm.ssm_block(bp, dataclasses.replace(jcfg, attn_impl="pallas"),
                                 jx.jnp.asarray(u))
    xla, _ = jx.ssm.ssm_block(bp, jcfg, jx.jnp.asarray(u))
    print(f"{model['arch']} ssm_block: max |port - pallas| {_max_err(out, pallas)!r} (bar "
          f"1e-5), max |port - xla| {_max_err(out, xla)!r} (bar 5e-4)")
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **SCAN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), **XLA_TOL)


def test_forward_matches_the_reference(jx, model):
    """Logits of the whole reduced model at S = 20; the hybrid applies its
    shared block before layer 0."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = _tokens(7, (2, 20))
    reset_calls()
    logits, _ = forward(model["p"], cfg, {"tokens": torch.from_numpy(toks)})
    assert CALLS["forward"] == 1 and logits.shape == (2, 20, VOCAB)
    batch = {"tokens": jx.jnp.asarray(toks)}
    pallas, _ = jx.forward(model["jp"], dataclasses.replace(jcfg, attn_impl="pallas"), batch)
    xla, _ = jx.forward(model["jp"], jcfg, batch)
    print(f"{model['arch']} forward: max |port - pallas| {_max_err(logits, pallas)!r} (bar "
          f"1e-5), max |port - xla| {_max_err(logits, xla)!r} (bar 5e-4)")
    np.testing.assert_allclose(logits.numpy(), np.asarray(pallas), **SCAN_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(xla), **XLA_TOL)


def test_hybrid_applies_the_shared_block_at_its_sites(jx):
    """zamba2-7b: 14 sites of 81 layers; a 3-layer reduced hybrid applies
    the shared block before layers 0 and 2, as the reference does."""
    from repro_torch.models.lm import _num_attn_sites

    assert _num_attn_sites(get_config("zamba2-7b")) == 14
    assert _num_attn_sites(get_config("mamba2-2.7b")) == 0
    arch = "zamba2-7b"
    jcfg = jx.get_reduced(arch, vocab_size=VOCAB, num_layers=3)
    cfg = get_reduced(arch, vocab_size=VOCAB, num_layers=3)
    jp = jx.init_params(jcfg, jx.jax.random.PRNGKey(2))
    p = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = _tokens(8, (1, 12))
    logits, _ = forward(p, cfg, {"tokens": torch.from_numpy(toks)})
    ref, _ = jx.forward(jp, dataclasses.replace(jcfg, attn_impl="pallas"),
                        {"tokens": jx.jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **SCAN_TOL)


def test_flash_plain_version_at_zamba2_head_dim(jx):
    """The shared block's attention at D = 112, MHA (zamba2-7b's 3584 / 32
    heads): the plain version against the Pallas kernel, 1e-5."""
    rs = np.random.default_rng(11)
    q, k, v = (rs.normal(size=(2, 16, 4, 112)).astype(np.float32) for _ in range(3))
    out = flash_attention(*_t(q, k, v))
    ref = jx.flash_attention(*_j(jx, q, k, v), block_q=8, block_k=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SCAN_TOL)


# ---------------------------------------------------------------------------
# Model-guided search
# ---------------------------------------------------------------------------

K, MAX_LEN, B = 4, 12, 8
PROMPT = np.array([3, 17, 42, 8], np.int32)
MODEL_SPEC = dict(algo="wu_uct", batch=B, num_simulations=8, wave_size=4, max_depth=4,
                  max_sim_steps=4, max_width=K, gamma=1.0, use_kernel=False)


def _key_data(seed, n=B):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


@pytest.mark.parametrize("engine", ["async", "wave"])
def test_model_guided_search_matches_the_reference(jx, model, engine):
    """``ModelEvaluator`` searches over the token environment, the port's
    against the reference's (its default XLA path), same roots and keys."""
    jcfg, cfg, jp, p = model["jcfg"], model["cfg"], model["jp"], model["p"]
    jax_env = jx.make_token_env(jcfg, jp, jx.jnp.asarray(PROMPT), max_len=MAX_LEN, top_k=K,
                                eos_token=1)
    env = make_token_env(cfg, p, torch.from_numpy(PROMPT), max_len=MAX_LEN, top_k=K,
                         eos_token=1)
    j_roots = jx.jax.vmap(jax_env.init)(jx.jnp.asarray(_key_data(5)))
    roots = convert.state_from_numpy(jx.jax.tree.map(np.asarray, j_roots), device="cpu")
    kd = _key_data(6)
    ref = jx.build_searcher(jax_env, jx.SearchSpec(engine=engine, **MODEL_SPEC),
                            evaluator=jx.ModelEvaluator(jcfg, jp, top_k=K, eos_token=1))(
        j_roots, jx.jnp.asarray(kd))
    reset_calls()
    res = build_searcher(env, SearchSpec(engine=engine, **MODEL_SPEC), device="cpu",
                         evaluator=ModelEvaluator(cfg, p, top_k=K, eos_token=1))(
        roots, convert.keys_from_numpy(kd, device="cpu"))
    assert CALLS["forward"] > 0 and CALLS["decode_step"] == 0
    ref_action, action = np.asarray(ref.action), res.action.numpy()
    same = ref_action == action
    for i in np.flatnonzero(~same):
        print(f"{model['arch']} {engine}: tree {i} reference action {ref_action[i]}, port "
              f"{action[i]} (root_n reference {np.asarray(ref.root_n)[i].tolist()}, port "
              f"{res.root_n[i].tolist()})")
    assert same.sum() >= 7, f"actions agree on {same.sum()} of {B} trees"
    assert bool((res.root_n.sum(1) <= MODEL_SPEC["num_simulations"]).all())


# ---------------------------------------------------------------------------
# What the port refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_refuse_the_decode_cache(arch):
    """The cached search evaluators still refuse a recurrent state, as the
    reference does (it has no per-position rollback); the recurrent decode
    cache itself runs: ``ssm_block``'s cache-producing prefill and O(1)
    step, and ``init_cache`` + ``decode_step`` from an empty cache equal
    the cache-free forward."""
    cfg = get_reduced(arch, vocab_size=VOCAB)
    p = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="recurrent"):
        CachedModelEvaluator(cfg, p, top_k=K, eos_token=1)
    bp = {k: v[0] for k, v in p["blocks"]["ssm"].items()}
    u = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(1))
    full, none = ssm.ssm_block(bp, cfg, u)
    assert none is None
    head, cache = ssm.ssm_block(bp, cfg, u[:, :5], return_cache=True)
    assert cache["conv"].shape == (2, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert cache["state"].shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    step, cache = ssm.ssm_block(bp, cfg, u[:, 5:], cache=cache)
    torch.testing.assert_close(torch.cat([head, step], dim=1), full, **SCAN_TOL)
    tokens = torch.tensor([[3, 9, 4]])
    logits, _ = forward(p, cfg, {"tokens": tokens})
    cache = init_cache(cfg, 1, 8, device="cpu")
    for t in range(3):
        got, cache = decode_step(p, cfg, tokens[:, t], cache)
        torch.testing.assert_close(got, logits[:, t], **SCAN_TOL)
    assert int(cache["len"]) == 3


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

# float32 on both sides from the same inputs; the kernel sums in another
# order (tile by tile, a warp scan for cum) than the plain version's einsums,
# and with bf16 B/C it also carries the split products' ~2^-17 relative error
# (tests/test_torch_ssd_numerics.py models it: at most ~3.5e-5).
CUDA_TOL = dict(rtol=1e-4, atol=1e-4)
# SSD_SHAPES and several chunks of 256; Q on both sides of the tensor-core
# body's 16-row tiles and 64-row blocks (1, 15, 16, 17, 63, 64, 65, 160,
# 256) with N in (8, 64, 128, 256) and P in (16, 64, 128), one and several
# chunks; odd P and N (element-wise loads and stores); and two shapes whose
# heads the block's group does not divide on an H100 (REMAINDER_SHAPES), one
# for each bf16 chunk kernel (the Hopper body at P = 64, N = 128, Q = 160:
# 20 heads in groups of 3; the mma.sync body at P = 16).
REMAINDER_SHAPES = [(16, 160, 20, 64, 128, 160), (96, 256, 7, 16, 64, 128)]
CUDA_SHAPES = SSD_SHAPES + [
    (1, 512, 4, 64, 128, 256), (2, 8, 3, 16, 8, 1), (1, 45, 5, 64, 64, 15),
    (2, 32, 3, 128, 256, 16), (1, 34, 9, 16, 128, 17), (1, 126, 3, 64, 8, 63),
    (2, 128, 2, 128, 64, 64), (1, 130, 11, 64, 128, 65), (1, 320, 3, 16, 256, 160),
    (1, 256, 5, 128, 256, 256), (2, 33, 3, 18, 12, 11),
    (128, 160, 13, 64, 128, 160)] + REMAINDER_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_kernel_matches_plain_version(bc_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan.ops import heads_per_block

    for b, s, h, p, n, chunk in CUDA_SHAPES:
        xdt, dA, bm, cm = (x.cuda() for x in _t(*_ssd_inputs(s, b, s, h, p, n)))
        bm, cm = bm.to(bc_dtype), cm.to(bc_dtype)
        before = LAUNCHES["ssd_scan"]
        out = ssd_scan(xdt, dA, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan"] == before + 1
        torch.testing.assert_close(out, ssd_scan_ref(xdt, dA, bm, cm, chunk=chunk),
                                   **CUDA_TOL)
        torch.testing.assert_close(out, ssm.ssd_sequential_ref(xdt, dA, bm, cm)[0], **SEQ_TOL)
    for b, s, h, p, n, chunk in REMAINDER_SHAPES:
        assert h % heads_per_block(b, s, h, p, n, chunk, xdt.device) != 0
    with pytest.raises(ValueError, match="does not divide"):
        ssd_scan(xdt[:, :20], dA[:, :20], bm[:, :20], cm[:, :20], chunk=8)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(xdt.double(), dA, bm, cm, chunk=chunk)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(xdt, dA, bm.half(), cm.half(), chunk=chunk)
