"""The port's runtime guard, ``repro_torch.analysis.retrace_guard``.

Unit behaviour, as ``tests/test_analysis.py`` holds the reference's: the
guard counts a watched counter's growth and passes while it stays within
its limit, raises past it, respects ``max_traces`` and ignores what was
counted before the region, refuses a non-counter, and lets an exception
already unwinding through the region pass.  The library-load counter grows
once per library opened, not on a cached handle.

The serving hot path: the ragged-arrival drain (R = 3 B requests through
B = 2 rows) of ``SearchService``, dense and paged, host-paced and fused,
served twice with the same prompts and keys by one service.  Under the
guard the second drain loads no kernel library and makes no more host
syncs than the first.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.analysis import (
    RetraceError,
    host_syncs,
    library_loads,
    retrace_guard,
)
from repro_torch.sync import host_any

torch.set_num_threads(2)

ARCH = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
            head_dim=16, d_ff=64)
PROMPTS = [[3, 5], [2, 9, 4], [7], [1, 2, 3], [5, 5], [6]]
SPEC = dict(algo="wu_uct", engine="async", batch=2, num_simulations=6, wave_size=2,
            max_depth=3, max_sim_steps=3, max_width=4, gamma=1.0)
SERVICE = dict(top_k=4, max_len=12, eos_token=1, block_size=4, ticks_per_round=4)


def _sync():
    host_any(torch.ones(1, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Unit behaviour
# ---------------------------------------------------------------------------


def test_retrace_guard_counts_and_passes_within_the_limit():
    with retrace_guard(syncs=host_syncs, loads=(library_loads, 0)) as g:
        _sync()
    assert g.counts() == {"syncs": 1, "loads": 0}


def test_retrace_guard_raises_past_the_limit():
    with pytest.raises(RetraceError, match=r"syncs: 2 \(limit 1\)"):
        with retrace_guard(syncs=host_syncs):
            _sync()
            _sync()


def test_retrace_guard_max_traces_and_earlier_counts():
    _sync()  # counted before the guard: not the region's
    with retrace_guard(max_traces=2, syncs=host_syncs) as g:
        _sync()
        _sync()
    assert g.counts() == {"syncs": 2}
    with retrace_guard(max_traces=2, syncs=(host_syncs, 3)) as g:
        for _ in range(3):
            _sync()
    assert g.counts() == {"syncs": 3}


def test_retrace_guard_rejects_non_counters_and_propagates_errors():
    with pytest.raises(TypeError, match="counter"):
        retrace_guard(f=lambda: "one")
    with pytest.raises(TypeError, match="counter"):
        retrace_guard(f=3)
    with pytest.raises(ValueError, match="at least one"):
        retrace_guard()
    # An exception inside the region is not masked by the exit check.
    with pytest.raises(KeyError):
        with retrace_guard(syncs=host_syncs):
            _sync()
            _sync()
            raise KeyError("boom")


def test_library_loads_count_real_opens_only(monkeypatch, tmp_path):
    """``_build.load`` counts a library when it opens it with ctypes, not
    when it hands back the cached handle."""
    from repro_torch.kernels import _build

    opened = []
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: tmp_path / f"{n}.so" for n in names})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: opened.append(path) or object())
    with pytest.raises(RetraceError, match=r"loads: 2 \(limit 0\)"):
        with retrace_guard(loads=(library_loads, 0)) as g:
            first = _build.load("a")
            assert _build.load("a") is first
            _build.load("b")
    assert g.counts() == {"loads": 2} and len(opened) == 2
    with retrace_guard(loads=(library_loads, 0)) as g:
        _build.load("a")
        _build.load("b")
    assert g.counts() == {"loads": 0}


# ---------------------------------------------------------------------------
# The serving hot path: a warm drain repeats nothing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params

    cfg = get_reduced("llama3-8b", **ARCH)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("fused", [False, True], ids=["host_paced", "fused"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_second_ragged_drain_repeats_nothing(tiny_lm, paged, fused):
    from repro_torch import rng
    from repro_torch.core import SearchSpec
    from repro_torch.serving import SearchService

    cfg, params = tiny_lm
    svc = SearchService(cfg, params, SearchSpec(**SPEC), paged=paged, fused=fused,
                        device="cpu", **SERVICE)
    keys = list(rng.split(rng.PRNGKey(11), len(PROMPTS)).numpy())
    with retrace_guard(max_traces=10 ** 9, syncs=host_syncs) as first:
        rows = svc.serve(PROMPTS, keys=keys)
    cold = first.counts()["syncs"]
    assert cold > 0
    with retrace_guard(loads=(library_loads, 0), syncs=(host_syncs, cold)) as g:
        again = svc.serve(PROMPTS, keys=keys)
    assert g.counts()["loads"] == 0 and 0 < g.counts()["syncs"] <= cold
    assert len(again) == len(rows) == len(PROMPTS)
    for a, b in zip(rows, again):
        assert int(a.action) == int(b.action)
        np.testing.assert_array_equal(a.root_n.numpy(), b.root_n.numpy())
