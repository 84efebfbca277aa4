"""The port's ``tree_select`` against the JAX kernel and its reference.

The JAX kernel runs in Pallas interpret mode, as ``tests/test_kernels.py``
runs it on the CPU.  The port's wrapper sends CPU tensors to its plain
version (``kernels/tree_select/ref.py``).  Scores go through float32
``log``, which differs between XLA and PyTorch in the last bit, so
``best`` is held to ``rtol=1e-6`` and ``act`` must be equal on every row
whose top two scores are exactly tied (both pick the first) or differ by
more than 1e-5 relative.  On a CUDA machine the hand-written kernel is
held against the plain version; that test imports no JAX, so it also
runs where JAX is not installed (``pytest -m cuda``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.tree_select.ops import tree_select
from repro_torch.kernels.tree_select.ref import KINDS, tree_select_ref, tree_select_scores

torch.set_num_threads(2)

PARAMS = dict(beta=1.3, r_vl=0.7, n_vl=1.5)


def _inputs(seed, b, a):
    """Selection tables with exact ties, all-invalid rows and unvisited
    (+inf) children, as float32/bool numpy arrays."""
    rs = np.random.default_rng(seed)
    n_c = np.floor(rs.random((b, a)) * 10).astype(np.float32)
    o_c = np.floor(rs.random((b, a)) * 3).astype(np.float32)
    v_c = rs.normal(size=(b, a)).astype(np.float32)
    vl_c = rs.random((b, a)).astype(np.float32)
    valid = rs.random((b, a)) < 0.7
    tie = rs.random(b) < 0.2                       # every child a copy of child 0
    for x in (n_c, o_c, v_c, vl_c):
        x[tie] = x[tie, :1]
    valid[rs.random(b) < 0.1] = False              # all-invalid rows
    unvisited = rs.random((b, a)) < 0.1
    n_c[unvisited] = 0.0
    o_c[unvisited] = 0.0
    n_p = n_c.sum(1) + 1
    o_p = o_c.sum(1)
    return n_c, o_c, v_c, n_p, o_p, valid, vl_c


def _decided_rows(scores):
    """Rows whose argmax is determined despite ulp-level score noise."""
    top = np.sort(scores, axis=1)[:, ::-1][:, :2]
    exact_tie = top[:, 0] == top[:, 1]
    with np.errstate(invalid="ignore"):
        clear = (top[:, 0] - top[:, 1]) > 1e-5 * np.abs(top[:, 0])
    return exact_tie | clear | ~np.isfinite(top[:, 1])


def _assert_matches(act, best, ref_act, ref_best, scores):
    np.testing.assert_allclose(best, ref_best, rtol=1e-6, atol=0)
    decided = _decided_rows(scores)
    np.testing.assert_array_equal(act[decided], ref_act[decided])


@pytest.mark.parametrize("kind", KINDS)
def test_ref_matches_jax_kernel_and_reference(kind):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.tree_select.ops import tree_select as jax_tree_select
    from repro.kernels.tree_select.ref import tree_select_ref as jax_tree_select_ref

    for a in (4, 16, 20, 81):
        for b in (1, 33, 96):
            arrays = _inputs(1000 * a + b, b, a)
            tensors = [torch.from_numpy(x) for x in arrays]
            act, best = tree_select(*tensors, kind=kind, **PARAMS)
            assert act.dtype == torch.int32 and best.dtype == torch.float32
            scores = tree_select_scores(*tensors, kind=kind, **PARAMS).numpy()
            j_args = [jnp.asarray(x) for x in arrays]
            for fn in (jax_tree_select, jax_tree_select_ref):
                j_act, j_best = fn(*j_args, kind=kind, **PARAMS)
                _assert_matches(act.numpy(), best.numpy(), np.asarray(j_act),
                                np.asarray(j_best), scores)


def test_ties_and_masks_follow_argmax_rules():
    """Exact ties pick the first child, several +inf children the first of
    them, all-invalid rows child 0 with score -1e30 — for every kind."""
    n_c = torch.tensor([[2.0, 2.0, 2.0], [0.0, 3.0, 0.0], [1.0, 1.0, 1.0]])
    o_c = torch.zeros_like(n_c)
    v_c = torch.tensor([[0.5, 0.5, 0.5], [0.1, 0.9, 0.2], [0.3, 0.2, 0.1]])
    n_p = n_c.sum(1) + 1
    o_p = torch.zeros(3)
    valid = torch.tensor([[False, True, True], [True, True, True], [False, False, False]])
    for kind in KINDS:
        act, best = tree_select(n_c, o_c, v_c, n_p, o_p, valid, kind=kind)
        assert act.tolist() == [1, 0, 0], kind
        assert best[1] == float("inf") and best[2] == -1e30, kind


def test_wrapper_rejects_unknown_kind_and_device():
    x = torch.zeros(2, 4)
    p = torch.zeros(2)
    v = torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown policy kind"):
        tree_select(x, x, x, p, p, v, kind="puct")
    meta = [t.to("meta") for t in (x, x, x, p, p, v)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tree_select(*meta)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card the kernel and its plain version round alike, so both
    outputs are equal bit for bit, near-ties included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    for kind in KINDS:
        for a in (4, 36, 81):
            for b in (1, 257, 4096):
                tensors = [torch.from_numpy(x).cuda() for x in _inputs(b + a, b, a)]
                before = LAUNCHES["tree_select"]
                act, best = tree_select(*tensors, kind=kind, **PARAMS)
                torch.cuda.synchronize()
                assert LAUNCHES["tree_select"] == before + 1
                ref_act, ref_best = tree_select_ref(*tensors, kind=kind, **PARAMS)
                assert torch.equal(act.long(), ref_act.long()), (kind, b, a)
                assert torch.equal(best, ref_best), (kind, b, a)
