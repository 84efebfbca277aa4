"""The port's train step, optimizer, compression, data pipeline and
checkpoints against the JAX package (counterparts of
``tests/test_training.py``), on reduced float32 configurations.

Parameters after 3 AdamW steps are held within the reference test's rtol
2e-4, atol 2e-5; the schedule within 1e-6; the compression, the data
pipeline and the checkpoints bit for bit.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed.compress import compress_decompress as jax_compress_decompress
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import PackedShards as JaxPackedShards
from repro.training import SyntheticStream as JaxSyntheticStream
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import adamw_init as jax_adamw_init
from repro.training import make_train_step as jax_make_train_step
from repro.training import write_token_shards as jax_write_token_shards
from repro.training.optimizer import cosine_schedule as jax_cosine_schedule
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.distributed.compress import compress_decompress, compress_with_feedback
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import tree_map
from repro_torch.training import (
    AdamWConfig,
    CheckpointManager,
    PackedShards,
    Prefetcher,
    SyntheticStream,
    TrainConfig,
    adamw_init,
    cosine_schedule,
    make_train_step,
    write_token_shards,
)
from repro_torch.training import checkpoint as checkpoint_mod
from repro_torch.training.optimizer import leaves
from test_torch_training import _batch, _jax, _leaf_pairs, _setup, _torch

torch.set_num_threads(2)

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


STEP_MODES = {"plain": {}, "microbatches": {"microbatches": 4},
              "compressed": {"compress_grads": True}}


@pytest.mark.parametrize("mode", sorted(STEP_MODES))
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_three_train_steps_match_the_reference(family, mode):
    """Parameters and master weights after 3 steps from the same
    parameters and state on the same batches; the reference test's
    optimizer settings.  With compression, a gradient entry within float32
    noise of a rounding boundary of the int8 grid (|g / scale - k - 1/2| <
    1e-4) may land one step of the grid apart on the two sides, which moves
    that parameter alone (AdamW is elementwise); those entries — a handful
    of the model's — are left out, every other parameter is held.  (The
    moments are not compared for the same reason; the gradients are held
    by ``test_grads_match_the_reference``.)"""
    jcfg, jp, cfg, p = _setup(family)
    ties = jax.tree.map(lambda x: np.zeros(x.shape, bool), jp)
    jgrad = jax.jit(jax.grad(lambda q, b: jax_loss_fn(q, jcfg, b)[0]))
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=50)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(optimizer=JaxAdamWConfig(**oc),
                                                             **STEP_MODES[mode])))
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(**oc), **STEP_MODES[mode]))
    jopt = jax_adamw_init(jp)
    opt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt), cfg, device="cpu")
    for i in range(3):
        batch = _batch(cfg, 10 + i, b=8, s=16)
        if mode == "compressed":
            ties = jax.tree.map(lambda t, g: t | _near_tie(np.asarray(g)), ties,
                                jgrad(jp, _jax(batch)))
        jp, jopt, jm = jstep(jp, jopt, _jax(batch))
        p, opt, m = step(p, opt, _torch(batch))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    assert int(opt.step) == int(jopt.step) == 3
    n_ties = sum(int(t.sum()) for t in jax.tree.leaves(ties))
    assert n_ties <= 1e-3 * sum(t.size for t in jax.tree.leaves(ties)), n_ties
    for tree_j, tree_t in ((jp, p), (jopt.master, opt.master)):
        for (a, b), tie in zip(_leaf_pairs(tree_j, tree_t), jax.tree.leaves(ties)):
            np.testing.assert_allclose(b.numpy()[~tie], np.asarray(a, np.float32)[~tie],
                                       **PARAM_TOL)


def _near_tie(g: np.ndarray) -> np.ndarray:
    """Entries of ``g`` within float32 noise of a rounding boundary of the
    int8 compression grid (``distributed/compress.py``)."""
    scale = np.abs(g).max() / 127.0 + 1e-12
    x = g / scale
    return np.abs(x - np.floor(x) - 0.5) < 1e-4


def test_train_step_decreases_loss_and_updates_in_place():
    _, _, cfg, p = _setup("dense")
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1,
                                                                  total_steps=50)))
    opt = adamw_init(p)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(leaves(p), leaves(opt.master)))
    batch = _torch(_batch(cfg, 6, b=4, s=32))
    embed = p["embed"]
    losses = []
    for _ in range(8):
        p, opt, m = step(p, opt, batch)
        losses.append(m["loss"])
    assert p["embed"] is embed                   # written in place
    assert losses[-1] < losses[0] - 0.1, losses
    assert isinstance(losses[0], float) and int(opt.step) == 8


def test_cosine_schedule_matches_the_reference():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = JaxAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(cosine_schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(cosine_schedule(cfg, torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(cosine_schedule(cfg, torch.tensor(100, dtype=torch.int32))) == pytest.approx(
        0.1, rel=1e-3)
    for step in (0, 1, 5, 10, 11, 37, 64, 99, 100, 150):
        got = cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jax_cosine_schedule(jcfg, jnp.int32(step))),
                                   rtol=1e-6)


def test_compression_matches_the_reference_and_feedback_stays_unbiased():
    g = np.random.default_rng(7).normal(size=(32, 32)).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]                     # ties round to even
    got = compress_decompress({"w": torch.from_numpy(g)})["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_compress_decompress(
        {"w": jnp.asarray(g)})["w"]))
    grads = {"w": torch.linspace(-1.0, 1.0, 1024).reshape(32, 32)}
    err = None
    acc_true = np.zeros((32, 32))
    acc_q = np.zeros((32, 32))
    for _ in range(50):
        gq, err = compress_with_feedback(grads, err)
        acc_true += grads["w"].numpy()
        acc_q += gq["w"].numpy()
    rel = np.abs(acc_q - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_synthetic_stream_is_bit_equal_and_sharded():
    for rank in (0, 1):
        ours = SyntheticStream(100, batch_size=8, seq_len=16, seed=3, dp_rank=rank, dp_world=2)
        ref = JaxSyntheticStream(100, batch_size=8, seq_len=16, seed=3, dp_rank=rank,
                                 dp_world=2)
        for step in (0, 7, 123):
            a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32 and a.shape == (4, 16)
            np.testing.assert_array_equal(a, b)
    s0 = SyntheticStream(100, batch_size=8, seq_len=16, seed=3, dp_rank=0, dp_world=2)
    s1 = SyntheticStream(100, batch_size=8, seq_len=16, seed=3, dp_rank=1, dp_world=2)
    assert not np.array_equal(s0.batch_at(7)["tokens"], s1.batch_at(7)["tokens"])


def test_packed_shards_match_the_reference(tmp_path):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    write_token_shards(ours, num_shards=2, tokens_per_shard=256, vocab_size=50, seed=1)
    jax_write_token_shards(ref, num_shards=2, tokens_per_shard=256, vocab_size=50, seed=1)
    for i in range(2):
        np.testing.assert_array_equal(np.load(os.path.join(ours, f"shard_{i:05d}.npy")),
                                      np.load(os.path.join(ref, f"shard_{i:05d}.npy")))
    a = PackedShards(ours, batch_size=4, seq_len=16, dp_rank=1, dp_world=2)
    b = JaxPackedShards(ref, batch_size=4, seq_len=16, dp_rank=1, dp_world=2)
    for step in (0, 1, 40):
        np.testing.assert_array_equal(a.batch_at(step)["tokens"], b.batch_at(step)["tokens"])
    assert a.batch_at(0)["tokens"].shape == (2, 16) and a.batch_at(0)["tokens"].max() < 50


def test_prefetcher_stages_batches_in_order():
    stream = SyntheticStream(64, batch_size=2, seq_len=8, seed=0)
    pre = Prefetcher(stream, start_step=5, device="cpu")
    try:
        for want in (5, 6, 7):
            step, batch = next(pre)
            assert step == want and batch["tokens"].dtype == torch.int64
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          stream.batch_at(want)["tokens"])
    finally:
        pre.close()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_restore_both_ways(tmp_path, dtype):
    """The reference's manager writes, the port's restores, and the
    reverse, with the same flattened keys; bfloat16 leaves bit for bit."""
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    jcfg = jax_get_reduced("llama3-8b", dtype=jnp.dtype(dtype))
    cfg = get_reduced("llama3-8b", dtype=tdtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jp)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    opt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jopt), cfg, device="cpu")

    JaxCheckpointManager(str(tmp_path / "ref")).save(7, (jp, jopt), blocking=True)
    like = (tree_map(torch.zeros_like, p), adamw_init(tree_map(torch.zeros_like, p)))
    step, (p2, opt2) = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 7
    for tree_j, tree_t in ((jp, p2), (jopt.m, opt2.m), (jopt.master, opt2.master)):
        for a, b in _leaf_pairs(tree_j, tree_t):
            assert b.dtype == (tdtype if tree_t is p2 else torch.float32)
            np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))

    CheckpointManager(str(tmp_path / "ours")).save(9, (p, opt), blocking=True)
    jlike = (jax.tree.map(jnp.zeros_like, jp), jax_adamw_init(jax.tree.map(jnp.zeros_like, jp)))
    step, (jp2, jopt2) = JaxCheckpointManager(str(tmp_path / "ours")).restore(jlike)
    assert step == 9
    for a, b in _leaf_pairs(jp2, p):
        assert a.dtype == jnp.dtype(dtype)
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    names = sorted(np.load(str(tmp_path / "ours" / "step_00000009" / "arrays.npz")).files)
    assert names == sorted(np.load(str(tmp_path / "ref" / "step_00000007" / "arrays.npz")).files)


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    _, _, cfg, p = _setup("dense")
    opt = adamw_init(p)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, (p, opt), blocking=True)
    assert mgr.all_steps() == [20, 30]           # keep-k
    step, (p2, _) = mgr.restore((p, opt))
    assert step == 30
    for a, b in zip(leaves(p), leaves(p2)):
        assert torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    """A stale tmp dir of a crashed save neither masks nor corrupts the
    published checkpoint."""
    _, _, cfg, p = _setup("dense")
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(str(tmp_path / "tmp.99"))
    os.makedirs(str(tmp_path / "step_00000098"))   # no manifest: not a checkpoint
    assert mgr.latest_step() is None
    mgr.save(99, p, blocking=True)
    assert mgr.all_steps() == [99]
    _, restored = mgr.restore(p)
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(restored)))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(p)


def test_async_save_keeps_the_saved_step_while_training_goes_on(tmp_path, monkeypatch):
    """A save that does not block holds the state of its own step, bit for
    bit, though the next train step rewrites the CPU leaves in place
    before the files are written."""
    _, _, cfg, p = _setup("dense")
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1,
                                                                  total_steps=50)))
    opt = adamw_init(p)
    batch = _torch(_batch(cfg, 6, b=4, s=32))
    p, opt, _ = step(p, opt, batch)
    saved = {k: torch.as_tensor(x).clone() for k, x in checkpoint_mod._items((p, opt))}

    go = threading.Event()
    savez = np.savez

    def late_savez(*args, **kwargs):             # the writer waits for the next step
        assert go.wait(60)
        savez(*args, **kwargs)

    monkeypatch.setattr(checkpoint_mod.np, "savez", late_savez)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (p, opt))
    p, opt, _ = step(p, opt, batch)
    go.set()
    mgr.wait()
    now = dict(checkpoint_mod._items((p, opt)))
    assert p["embed"].data_ptr() == now["0/embed"].data_ptr()
    assert not torch.equal(saved["0/embed"], p["embed"])     # the step did rewrite it
    _, restored = mgr.restore((p, opt))
    restored = dict(checkpoint_mod._items(restored))
    assert sorted(restored) == sorted(saved)
    for k, x in saved.items():
        assert torch.equal(torch.as_tensor(restored[k]), x), k


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    common = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--seq", "32",
              "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    _, _, records = launch_train.main(common + ["--steps", "4", "--ckpt-every", "2"])
    assert [r.step for r in records] == [1, 2, 3, 4]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    _, _, records = launch_train.main(common + ["--steps", "6"])
    assert [r.step for r in records] == [5, 6]
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    assert all(np.isfinite(r.loss) and np.isfinite(r.grad_norm) for r in records)
