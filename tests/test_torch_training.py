"""The port's loss and gradients against the JAX package, on reduced
float32 configurations (``tests/test_torch_train_step.py`` holds the train
step, data and checkpoints: the counterparts of ``tests/test_training.py``).

Parameters come from ``repro.models.init_params`` and are carried across
with ``repro_torch.convert.params_from_numpy`` (the optimizer state with
``opt_state_from_numpy``); batches are made with numpy from a seed.

Tolerances: the loss within rtol 1e-5 (both sides compute the same float32
expressions, summed in other orders); gradients within rtol 1e-4 with atol
1e-6 (the backward sums over tokens and heads, a few hundred ulps of the
smallest entries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import abstract_params as jax_abstract_params
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.models import abstract_params, loss_fn
from repro_torch.models.lm import tree_map
from repro_torch.training.optimizer import leaves

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = {"dense": "llama3-8b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
         "hybrid": "zamba2-7b", "vlm": "llava-next-mistral-7b", "encdec": "whisper-small"}


def _setup(family, **overrides):
    arch = ARCHS[family]
    jcfg = dataclasses.replace(jax_get_reduced(arch), **overrides)
    cfg = dataclasses.replace(get_reduced(arch), **overrides)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, p


def _batch(cfg, seed, b=2, s=20):
    g = np.random.default_rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = g.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = g.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _leaf_pairs(jax_tree, torch_tree):
    """(jax leaf, torch leaf) in the reference's order (sorted dict keys)."""
    jl = jax.tree.leaves(jax_tree)
    tl = leaves(torch_tree)
    assert len(jl) == len(tl)
    return zip(jl, tl)


def _torch_grads(p, cfg, batch):
    live = tree_map(lambda x: x.clone().requires_grad_(), p)
    loss, metrics = loss_fn(live, cfg, batch)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda x: x.grad, live)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "encdec"])
def test_loss_fn_matches_the_reference(family, loss_chunk):
    """Both branches: full logits (vlm patches dropped) and the chunked
    head, the sequence padded to a multiple of the chunk (19 targets)."""
    jcfg, jp, cfg, p = _setup(family, loss_chunk=loss_chunk)
    batch = _batch(cfg, 1)
    jl, jm = jax_loss_fn(jp, jcfg, _jax(batch))
    with torch.no_grad():
        tl, tm = loss_fn(p, cfg, _torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-7)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 19


def test_loss_mask_counts_only_masked_positions():
    jcfg, jp, cfg, p = _setup("dense")
    batch = _batch(cfg, 2)
    batch["loss_mask"] = (np.random.default_rng(3).random((2, 20)) < 0.5).astype(np.float32)
    jl, jm = jax_loss_fn(jp, jcfg, _jax(batch))
    with torch.no_grad():
        tl, tm = loss_fn(p, cfg, _torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) == batch["loss_mask"][:, 1:].sum()


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "vlm", "encdec"])
def test_grads_match_the_reference(family):
    jcfg, jp, cfg, p = _setup(family)
    batch = _batch(cfg, 4)
    (jl, _), jg = jax.value_and_grad(lambda q: jax_loss_fn(q, jcfg, _jax(batch)),
                                     has_aux=True)(jp)
    tl, _, tg = _torch_grads(p, cfg, _torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)
    for a, b in _leaf_pairs(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL)


@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec"])
def test_remat_gives_the_same_grads(family):
    """``cfg.remat`` recomputes each layer (and each encoder layer) in the
    backward; the gradients do not move."""
    _, _, cfg, p = _setup(family)
    batch = _torch(_batch(cfg, 5))
    plain = _torch_grads(p, cfg, batch)
    remat = _torch_grads(p, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(leaves(plain[2]), leaves(remat[2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_the_reference(arch):
    """Shapes and dtypes of every leaf, at the published sizes, without
    allocating (``meta`` tensors)."""
    ref = jax_abstract_params(jax_get_config(arch))
    got = abstract_params(get_config(arch))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = leaves(got)
    assert len(flat_ref) == len(got_leaves)
    for (path, a), b in zip(flat_ref, got_leaves):
        assert b.device.type == "meta", path
        assert tuple(b.shape) == tuple(a.shape), path
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
