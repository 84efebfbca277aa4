"""Guards of the PyTorch/CUDA port's boundaries.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package ``repro`` (only the tests import both);
* the entry points run on CUDA unless the caller asks for the CPU: on a
  machine without a card, ``build_searcher``, ``play_episode``, the
  launchers (search, train) and the examples raise instead of running on
  the CPU, and the training data's prefetcher takes its device explicitly;
* selection on a GPU always goes through the kernel;
* each kernel is built with its own nvcc flags, and the library's name
  hashes them and the ``csrc/`` headers its source includes;
* ``build_searcher`` takes all six algos and refuses what the reference
  refuses (LeafP and RootP on the async engine or batched, unknown algos),
  the cached evaluators (dense, paged, frontier) on the wave engine and a
  model evaluator whose top-K does not match the environment; the search
  service runs its fused request ring by default (``fused=True``).
"""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch import rng
from repro_torch.configs import get_reduced
from repro_torch.core import (
    CachedModelEvaluator,
    FrontierModelEvaluator,
    ModelEvaluator,
    PagedCachedModelEvaluator,
    PagedFrontierModelEvaluator,
    SearchSpec,
    build_searcher,
    play_episode,
)
from repro_torch.envs import make_bandit_tree, make_token_env
from repro_torch.kernels import _build
from repro_torch.launch import search as launch_search
from repro_torch.models import init_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    port = REPO / "src" / "repro_torch"
    for path in (port / "serving" / "search_service.py", port / "serving" / "admission.py",
                 port / "envs" / "random_mdp.py", port / "configs" / "wu_uct_paper.py",
                 port / "core" / "baselines.py", port / "launch" / "train.py",
                 port / "distributed" / "compress.py"):
        assert path in PORT_FILES, path
    for module in ("optimizer", "train_step", "data", "checkpoint"):
        assert port / "training" / f"{module}.py" in PORT_FILES, module
    for module in ("quickstart", "passrate_prediction", "train_policy", "serve_search"):
        assert port / "examples" / f"{module}.py" in PORT_FILES, module
    for kernel in ("tree_select", "decode_attention", "flash_attention",
                   "paged_decode_attention", "tree_decode_attention", "ssd_scan",
                   "flash_attention_bwd", "ssd_scan_bwd"):
        assert (REPO / "src" / "repro_torch" / "csrc" / f"{kernel}.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_guard_catches_forbidden_imports():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_build_searcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    env = make_bandit_tree(depth=3, num_actions=3)
    for batch in (0, 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_searcher(env, SearchSpec(batch=batch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_searcher(env, SearchSpec(), device="cuda")
    assert callable(build_searcher(env, SearchSpec(), device="cpu"))


def test_play_episode_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    env = make_bandit_tree(depth=3, num_actions=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        play_episode(env, SearchSpec().config, rng.PRNGKey(0), max_moves=1)


def test_plain_selection_only_on_the_cpu():
    """``use_kernel=False`` may not route selection on a GPU around the
    kernel; on the CPU the plain version runs either way."""
    env = make_bandit_tree(depth=3, num_actions=3)
    spec = SearchSpec(batch=2, num_simulations=4, wave_size=2, max_depth=3,
                      max_sim_steps=3, max_width=3, use_kernel=False)
    for device in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="use_kernel=False"):
            build_searcher(env, spec, device=device)
    roots = env.init(rng.split(rng.PRNGKey(0), 2))
    keys = rng.split(rng.PRNGKey(1), 2)
    plain = build_searcher(env, spec, device="cpu")(roots, keys)
    default = build_searcher(env, spec._replace(use_kernel=True), device="cpu")(roots, keys)
    for a, b in zip(plain, default):
        assert torch.equal(a, b)


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_search.main(["--env", "bandit", "--batch", "2", "--simulations", "4",
                            "--workers", "2"])


def test_train_launcher_and_prefetcher_default_to_cuda():
    """``launch.train`` (its CLI and its loop) runs on CUDA unless asked for
    the CPU; the prefetcher has no default device."""
    from repro_torch.launch import train as launch_train
    from repro_torch.training import Prefetcher, SyntheticStream, TrainConfig

    with pytest.raises(TypeError, match="device"):
        Prefetcher(SyntheticStream(16, 1, 4))
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1", "--batch", "1", "--seq", "8"])
    cfg, _ = _tiny_lm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(cfg, TrainConfig(), steps=1, batch=1, seq=8)


def test_unported_paths_raise_not_implemented():
    """What stays refused: LeafP and RootP on the async engine or batched
    (the reference's ``ValueError``) and unknown algos.  All six algos
    build on the CPU, and the search service's fused request ring, its
    default, serves on it."""
    from repro_torch.serving import SearchService

    env = make_bandit_tree(depth=3, num_actions=3)
    for algo in ("leafp", "rootp"):
        with pytest.raises(ValueError, match="engine='async' supports wave-engine algos"):
            build_searcher(env, SearchSpec(algo=algo, engine="async"), device="cpu")
        for engine in ("wave", "async"):
            with pytest.raises(ValueError, match="supports wave-engine algos"):
                build_searcher(env, SearchSpec(algo=algo, engine=engine, batch=2),
                               device="cpu")
    with pytest.raises(ValueError, match="unknown algo"):
        build_searcher(env, SearchSpec(algo="mcts"), device="cpu")
    for algo in ("wu_uct", "uct", "treep", "treep_vc", "leafp", "rootp"):
        assert callable(build_searcher(env, SearchSpec(algo=algo), device="cpu"))
    for batch in (0, 2):
        assert callable(build_searcher(env, SearchSpec(engine="async", batch=batch),
                                       device="cpu"))
    cfg, params = _tiny_lm()
    spec = SearchSpec(engine="async", batch=2, num_simulations=4, wave_size=2, max_depth=2,
                      max_sim_steps=2)
    for kw in ({}, {"fused": True}):
        svc = SearchService(cfg, params, spec, device="cpu", top_k=4, max_len=8, **kw)
        assert svc.fused
        rows = svc.serve([[3, 5], [7], [2, 9, 4]])
        assert len(rows) == 3 and svc.stats.completed == 3
        assert svc.stats.ring_occupancy > 0.0 and svc._ring is not None


def _tiny_lm():
    cfg = get_reduced("llama3-8b", vocab_size=16, num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=1, head_dim=8, d_ff=32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


PAGED_KW = dict(block_size=2, num_blocks=16)
CACHED_SUBCLASSES = {
    "PagedCachedModelEvaluator": (PagedCachedModelEvaluator, PAGED_KW),
    "FrontierModelEvaluator": (FrontierModelEvaluator, {}),
    "PagedFrontierModelEvaluator": (PagedFrontierModelEvaluator, PAGED_KW),
}


def _cached_subclass(name):
    cfg, params = _tiny_lm()
    cls, kw = CACHED_SUBCLASSES[name]
    env = make_token_env(cfg, params, torch.tensor([2, 3]), max_len=6, top_k=3, eos_token=1)
    return env, cls(cfg, params, top_k=3, eos_token=1, **kw)


@pytest.mark.parametrize("name", sorted(CACHED_SUBCLASSES))
def test_paged_and_frontier_evaluators_build_on_the_async_engine(name):
    """The paged and frontier evaluators build through ``build_searcher``
    on the async engine (batch 0 and B) and run there."""
    env, ev = _cached_subclass(name)
    for batch in (0, 2):
        spec = SearchSpec(engine="async", batch=batch, num_simulations=4, wave_size=2,
                          max_depth=2, max_sim_steps=2, max_width=3, gamma=1.0)
        search = build_searcher(env, spec, evaluator=ev, device="cpu")
        n = max(batch, 1)
        roots, keys = env.init(rng.split(rng.PRNGKey(0), n)), rng.split(rng.PRNGKey(1), n)
        if not batch:
            roots, keys = type(roots)(*(x[0] for x in roots)), keys[0]
        res = search(roots, keys)
        assert int(res.root_n.sum()) > 0


@pytest.mark.parametrize("name", sorted(CACHED_SUBCLASSES))
def test_paged_and_frontier_evaluators_reject_the_wave_engine(name):
    env, ev = _cached_subclass(name)
    for batch in (0, 2):
        with pytest.raises(ValueError, match="requires engine='async'"):
            build_searcher(env, SearchSpec(batch=batch), evaluator=ev, device="cpu")


@pytest.mark.parametrize("name", sorted(CACHED_SUBCLASSES))
def test_paged_and_frontier_evaluators_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    env, ev = _cached_subclass(name)
    for batch in (0, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_searcher(env, SearchSpec(engine="async", batch=batch), evaluator=ev)


def test_model_evaluators_are_checked_against_the_engine_and_env():
    cfg, params = _tiny_lm()
    env = make_token_env(cfg, params, torch.tensor([2, 3]), max_len=6, top_k=3, eos_token=1)
    cached = CachedModelEvaluator(cfg, params, top_k=3, eos_token=1)
    for batch in (0, 2):
        with pytest.raises(ValueError, match="requires engine='async'"):
            build_searcher(env, SearchSpec(batch=batch), evaluator=cached, device="cpu")
        assert callable(build_searcher(env, SearchSpec(engine="async", batch=batch),
                                       evaluator=cached, device="cpu"))
    with pytest.raises(ValueError, match="top_k=4"):
        build_searcher(env, SearchSpec(engine="async"), device="cpu",
                       evaluator=ModelEvaluator(cfg, params, top_k=4))
    with pytest.raises(TypeError, match="Evaluator"):
        build_searcher(env, SearchSpec(), evaluator=object(), device="cpu")


def test_model_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    cfg, params = _tiny_lm()
    env = make_token_env(cfg, params, torch.tensor([2, 3]), max_len=6, top_k=3, eos_token=1)
    ev = CachedModelEvaluator(cfg, params, top_k=3, eos_token=1)
    for batch in (0, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_searcher(env, SearchSpec(engine="async", batch=batch), evaluator=ev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_search.main(["--env", "bandit", "--engine", "async", "--batch", "2",
                            "--simulations", "4", "--workers", "2"])
    from repro_torch.serving import SearchService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(cfg, params, SearchSpec(engine="async", batch=2), fused=False)


def test_each_kernel_has_its_own_flags_and_they_name_its_library(monkeypatch):
    flags = {name: _build.nvcc_flags(name) for name in _build.KERNEL_FLAGS}
    assert "--fmad=false" in flags["tree_select"]
    for name in ("decode_attention", "flash_attention", "paged_decode_attention",
                 "tree_decode_attention", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd"):
        assert "--fmad=false" not in flags[name]
        assert "arch=compute_90a,code=sm_90a" in flags[name]
    for name in ("ssd_scan", "ssd_scan_bwd"):
        assert "--use_fast_math" not in flags[name]       # accurate expf
    before = _build.library_path("decode_attention")
    monkeypatch.setitem(_build.KERNEL_FLAGS, "decode_attention", ("--use_fast_math",))
    after = _build.library_path("decode_attention")
    assert after != before and after.name.startswith("libdecode_attention-")
    assert _build.library_path("tree_select").name.startswith("libtree_select-")


def test_library_name_hashes_included_headers(monkeypatch, tmp_path):
    """A change to a ``csrc/`` header that a source includes renames (and so
    rebuilds) the library; nvcc is not needed to tell."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nint f() { return g(); }\n')
    (tmp_path / "shared.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.KERNEL_FLAGS, "k", ())
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    (tmp_path / "shared.cuh").write_text("inline int g() { return 2; }\n")
    after = _build.library_path("k")
    assert after != before and after.name.startswith("libk-")
    monkeypatch.undo()
    # The four decode kernels run the key-split body, which includes
    # decode_tiles.cuh for its Rows policies.
    for real in ("decode_attention", "paged_decode_attention", "tree_decode_attention"):
        files = {p.name for p in _build._sources(_build.CSRC / f"{real}.cu", {})}
        assert files == {f"{real}.cu", "decode_split.cuh", "decode_tiles.cuh"}


def test_launcher_runs_on_cpu_when_asked(capsys):
    common = ["--env", "bandit", "--simulations", "4", "--workers", "2", "--device", "cpu"]
    launch_search.main(common + ["--batch", "2", "--profile"])
    out = capsys.readouterr().out
    assert "searches/s" in out and "host syncs" in out
    launch_search.main(common + ["--episodes", "1"])
    assert "game_steps" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_search_matches_cpu_search():
    """The GPU path (the walk kernel, int64 threefry on the card) makes the
    CPU path's decisions on the bandit tree, where every draw is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import LAUNCHES

    env = make_bandit_tree(depth=4, num_actions=4, seed=3)
    spec = SearchSpec(batch=8, num_simulations=16, wave_size=4, max_depth=4,
                      max_sim_steps=4, max_width=4, gamma=0.9)
    roots = env.init(rng.split(rng.PRNGKey(0), 8))
    rngs = rng.split(rng.PRNGKey(1), 8)
    before = LAUNCHES["tree_descend"]
    gpu = build_searcher(env, spec)(roots, rngs)
    # One walk per selection: W slots in each of T / W waves.
    assert LAUNCHES["tree_descend"] == before + spec.num_simulations
    cpu = build_searcher(env, spec, device="cpu")(roots, rngs)
    for field in ("action", "root_n", "tree_size", "overflowed"):
        assert torch.equal(getattr(gpu, field).cpu(), getattr(cpu, field)), field
    torch.testing.assert_close(gpu.root_v.cpu(), cpu.root_v, rtol=1e-6, atol=0)
