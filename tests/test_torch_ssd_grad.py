"""The gradient of ``ssd_scan`` in the PyTorch/CUDA port.

* the plain backward ``ssd_scan_bwd_ref`` (closed form) against autograd of
  the plain forward ``ssd_scan_ref`` (float32 and bf16 B/C), and against
  ``jax.vjp`` of the reference's ``ssd_ref_chunked`` (XLA's
  ``ssd_chunked``, which the JAX package trains through) in float32;
* gradients that cross chunk boundaries, and a zero cotangent;
* the wiring of the autograd function ``SsdScan`` (its two launches
  pointed at the plain versions), and the reduced mamba2 and zamba2
  ``loss_fn`` gradients through it against today's CPU autograd and the
  JAX package's;
* on a card (``cuda``-marked), the backward kernel against its plain
  version, a second call bit-equal, its launch count, and autograd through
  ``ssd_scan``.

Tolerances: against PyTorch's autograd ``dxdt``, ``dB`` and ``dC`` are
sums of products of the same float32 values in another order: rtol 1e-5
and atol 1e-6.  ``ddA`` is a difference of row and column sums through
``exp(cum_i - cum_j)``, which cancels, so it is held per tensor: within
1e-5 of its largest value.  Against XLA, whose einsums reduce in other
orders, ``dxdt``, ``dB`` and ``dC`` are held elementwise at rtol 1e-4 and
atol 2e-5, ``ddA`` per tensor as above: autograd of the plain forward
itself differs from ``jax.vjp`` by up to 1.3e-5 absolute (2.7e-6 of the
largest value) on these shapes, so an atol of 1e-6 fails for near-zero
entries whichever backward is used.  bf16 ``dB``/``dC`` are
float32 sums rounded once, so within one bf16 ulp (2^-7 relative).  Model
gradients: ``tests/test_torch_training.py``'s ``GRAD_TOL``.

JAX is imported by the ``jx`` fixture only, so the file also runs on the
card's machine, which has no JAX (``pytest -m cuda``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_chunk_states_ref, ssd_scan_bwd_ref, ssd_scan_ref

torch.set_num_threads(2)

# (b, s, h, p, n, chunk): ``tests/test_torch_ssm.py``'s SSD_SHAPES.
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 64),
              (2, 96, 3, 16, 8, 32), (1, 81, 2, 16, 8, 81), (2, 20, 4, 16, 16, 4)]
NAMES = ("dxdt", "ddA", "dB", "dC")
TORCH_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=2e-5)
SHARE = 1e-5                  # max |a - b| <= this x max |b|, per tensor
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def _ssd_inputs(seed, b, s, h, p, n):
    """``tests/test_torch_ssm.py``'s inputs (the JAX tests' distributions)
    and a N(0, 1) cotangent."""
    rs = np.random.default_rng(seed)
    xdt = (rs.normal(size=(b, s, h, p)) * 0.3).astype(np.float32)
    dA = (-np.logaddexp(rs.normal(size=(b, s, h)), 0.0)).astype(np.float32)
    bm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rs.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    dy = rs.normal(size=(b, s, h, p)).astype(np.float32)
    return xdt, dA, bm, cm, dy


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    import test_torch_training as training
    from repro.kernels.ssd_scan.ref import ssd_ref_chunked

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ssd_ref_chunked=ssd_ref_chunked,
                                 training=training)


def _tensors(arrays, bc_dtype=torch.float32):
    xdt, dA, bm, cm, dy = (torch.from_numpy(x) for x in arrays)
    return xdt, dA, bm.to(bc_dtype), cm.to(bc_dtype), dy


def _autograd(xdt, dA, bm, cm, dy, chunk):
    leaves = [x.clone().requires_grad_() for x in (xdt, dA, bm, cm)]
    torch.autograd.backward(ssd_scan_ref(*leaves, chunk=chunk), dy)
    return [x.grad for x in leaves]


def _assert_grads(got, want, tol=None, what="", names=NAMES):
    """``tol`` elementwise, and ddA (every tensor without ``tol``) per
    tensor within :data:`SHARE` of its largest value."""
    for name, a, b in zip(names, got, want):
        if name == "ddA" or tol is None:
            share = float((a - b).abs().max()) / float(b.abs().max())
            assert share <= SHARE, f"{what} {name} differs by {share} of its largest value"
        else:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **tol,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd(shape, bc_dtype):
    *dims, chunk = shape
    xdt, dA, bm, cm, dy = _tensors(_ssd_inputs(1, *dims), bc_dtype)
    got = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk)
    want = _autograd(xdt, dA, bm, cm, dy, chunk)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, bc_dtype, bc_dtype]
    tol = TORCH_TOL if bc_dtype == torch.float32 else BF16_TOL
    _assert_grads(got[:2], want[:2], TORCH_TOL, str(shape))
    for name, a, b in zip(NAMES[2:], got[2:], want[2:]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **tol, err_msg=name)


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_vjp(jx, shape):
    """In float32, against the gradient the JAX package trains with."""
    *dims, chunk = shape
    arrays = _ssd_inputs(2, *dims)
    y, vjp = jx.jax.vjp(lambda *a: jx.ssd_ref_chunked(*a, chunk=chunk),
                        *(jx.jnp.asarray(x) for x in arrays[:4]))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jx.jnp.asarray(arrays[4]))]
    xdt, dA, bm, cm, dy = _tensors(arrays)
    np.testing.assert_allclose(ssd_scan_ref(xdt, dA, bm, cm, chunk=chunk).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    _assert_grads(ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk), want, JAX_TOL,
                  str(shape))


def test_gradients_cross_chunk_boundaries():
    """A cotangent on the last of four chunks only, as autograd's: the
    earlier chunks' xdt, dA and B reach it through the carried state and
    get a gradient; their C reads only their own y and gets none."""
    b, s, h, p, n, chunk = 2, 64, 3, 16, 8, 16
    xdt, dA, bm, cm, dy = _tensors(_ssd_inputs(3, b, s, h, p, n))
    dy[:, : s - chunk] = 0.0
    got = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk)
    _assert_grads(got, _autograd(xdt, dA, bm, cm, dy, chunk), TORCH_TOL)
    for name, g in zip(NAMES, got):
        for c0 in range(0, s - chunk, chunk):
            largest = float(g[:, c0:c0 + chunk].abs().max())
            assert (largest == 0.0) if name == "dC" else (largest > 0.0), (name, c0)
        assert float(g[:, s - chunk:].abs().max()) > 0.0, name
    zero = ssd_scan_bwd_ref(xdt, dA, bm, cm, torch.zeros_like(dy), chunk=chunk)
    for name, g in zip(NAMES, zero):
        assert torch.equal(g, torch.zeros_like(g)), name


def _overflow_inputs():
    """One chunk of 64 tokens whose cum falls by 2 a token: the
    differences above the diagonal reach 126, past float32's exp range."""
    xdt, _, bm, cm, dy = _ssd_inputs(7, 1, 64, 2, 8, 8)
    return xdt, np.full((1, 64, 2), -2.0, np.float32), bm, cm, dy


def test_gradients_stay_finite_where_the_decay_overflows():
    """Autograd of the plain scans (the CPU training path) stays finite and
    equal to the closed form where exp above the diagonal overflows: the
    masked differences go to -inf before the exp, not 0 * inf after it."""
    from repro_torch.models.ssm import ssd_chunked

    xdt, dA, bm, cm, dy = _tensors(_overflow_inputs())
    want = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=64)
    for scan in (lambda *a: ssd_scan_ref(*a, chunk=64), lambda *a: ssd_chunked(*a, 64)[0]):
        leaves = [x.clone().requires_grad_() for x in (xdt, dA, bm, cm)]
        torch.autograd.backward(scan(*leaves), dy)
        got = [x.grad for x in leaves]
        assert all(bool(torch.isfinite(g).all()) for g in got)
        _assert_grads(got, want, TORCH_TOL)


def test_the_reference_gradient_overflows_where_the_port_does_not(jx):
    """The reference's ``where(tri, exp(seg), 0)`` gives a NaN ``ddA`` on
    those inputs (a deliberate difference: the port's is finite); the
    other gradients and ``y`` agree."""
    arrays = _overflow_inputs()
    y, vjp = jx.jax.vjp(lambda *a: jx.ssd_ref_chunked(*a, chunk=64),
                        *(jx.jnp.asarray(x) for x in arrays[:4]))
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jx.jnp.asarray(arrays[4]))]
    xdt, dA, bm, cm, dy = _tensors(arrays)
    np.testing.assert_allclose(ssd_scan_ref(xdt, dA, bm, cm, chunk=64).numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    assert not bool(torch.isfinite(ref[1]).all())
    got = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=64)
    assert bool(torch.isfinite(got[1]).all())
    keep = (0, 2, 3)
    _assert_grads([got[i] for i in keep], [ref[i] for i in keep], JAX_TOL,
                  names=[NAMES[i] for i in keep])


@pytest.fixture
def plain_kernels(monkeypatch):
    """``SsdScan``'s launches pointed at the plain forward (with the states
    it keeps) and backward, counted."""
    calls = {"forward": 0, "backward": 0}

    def forward(xdt, dA, bm, cm, *, chunk, keep_states):
        calls["forward"] += 1
        assert keep_states
        return (ssd_scan_ref(xdt, dA, bm, cm, chunk=chunk),
                ssd_chunk_states_ref(xdt, dA, bm, cm, chunk))

    def backward(*args, chunk, states):
        calls["backward"] += 1
        return ssd_scan_bwd_ref(*args, chunk=chunk, states=states)

    monkeypatch.setattr(ssd_ops.KERNEL, "forward", forward)
    monkeypatch.setattr(ssd_ops.KERNEL, "backward", backward)
    return calls


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_wiring(plain_kernels, bc_dtype):
    b, s, h, p, n, chunk = 2, 96, 3, 16, 8, 32
    xdt, dA, bm, cm, dy = _tensors(_ssd_inputs(4, b, s, h, p, n), bc_dtype)
    leaves = [x.clone().requires_grad_() for x in (xdt, dA, bm, cm)]
    y = ssd_ops.SsdScan.apply(*leaves, chunk)
    assert torch.equal(y.detach(), ssd_scan_ref(xdt, dA, bm, cm, chunk=chunk))
    y.backward(dy)
    assert plain_kernels == {"forward": 1, "backward": 1}
    want = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert leaf.grad.dtype == w.dtype, name
        assert torch.equal(leaf.grad, w), name
    assert leaves[2].grad.dtype == bc_dtype
    ctx = types.SimpleNamespace(saved_tensors=(xdt, dA, bm, cm, None), chunk=chunk)
    grads = ssd_ops.SsdScan.backward(ctx, dy)
    assert len(grads) == 5 and grads[-1] is None


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_model_grads_through_the_autograd_function(jx, plain_kernels, monkeypatch, family):
    """Reduced mamba2 and zamba2 (5 chunks of 4 tokens): ``loss_fn``'s
    gradients with the scan through ``SsdScan`` equal today's CPU autograd
    of the plain scan and the JAX package's."""
    from repro_torch.models import ssm

    tr = jx.training
    jcfg, jp, cfg, p = tr._setup(family)
    batch = tr._batch(cfg, 4)
    _, _, plain = tr._torch_grads(p, cfg, tr._torch(batch))
    assert plain_kernels["forward"] == 0

    def scan(xdt, dA, bm, cm, *, chunk, return_state=False):
        assert not return_state
        return ssd_ops.SsdScan.apply(xdt, dA, bm, cm, chunk)

    monkeypatch.setattr(ssm, "ssd_scan", scan)
    loss, _, through = tr._torch_grads(p, cfg, tr._torch(batch))
    assert plain_kernels == {"forward": cfg.num_layers, "backward": cfg.num_layers}
    (jl, _), jg = jx.jax.value_and_grad(
        lambda q: tr.jax_loss_fn(q, jcfg, tr._jax(batch)), has_aux=True)(jp)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **tr.LOSS_TOL)
    for a, b, c in zip(tr.leaves(through), tr.leaves(plain), jx.jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tr.GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **tr.GRAD_TOL)


def test_remat_runs_the_scan_twice_and_its_backward_once(plain_kernels, monkeypatch):
    """Under ``cfg.remat`` (non-reentrant checkpoint) each block's scan runs
    in the forward and again in the backward's recompute, and its backward
    once: the launch identities chip_smoke's phase 24(c) holds."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params, loss_fn, ssm
    from repro_torch.models.lm import tree_map

    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"), remat=True)
    live = tree_map(lambda x: x.requires_grad_(),
                    init_params(cfg, torch.Generator().manual_seed(0)))
    monkeypatch.setattr(ssm, "ssd_scan", lambda *a, chunk, return_state=False:
                        ssd_ops.SsdScan.apply(*a, chunk))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)))
    loss, _ = loss_fn(live, cfg, {"tokens": tokens})
    loss.backward()
    assert plain_kernels == {"forward": 2 * cfg.num_layers, "backward": cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_backward_kernel_matches_plain_version(bc_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    dev = torch.device("cuda")
    # mamba2's and zamba2's training shapes cut to 2 rows, four chunks of
    # 64, and ragged Q, P and N.
    for shape in SSD_SHAPES + [(2, 512, 80, 64, 128, 256), (2, 512, 112, 64, 64, 256),
                               (2, 256, 5, 64, 128, 64), (1, 130, 11, 64, 128, 65),
                               (2, 33, 3, 18, 12, 11), (1, 256, 5, 128, 256, 256)]:
        *dims, chunk = shape
        xdt, dA, bm, cm, dy = (x.to(dev) for x in _tensors(_ssd_inputs(6, *dims), bc_dtype))
        before = LAUNCHES["ssd_scan_bwd"]
        got = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=chunk)
        assert LAUNCHES["ssd_scan_bwd"] == before + 1
        again = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, again))     # no atomics
        ref = ssd_scan_bwd_ref(xdt, dA, bm.float(), cm.float(), dy, chunk=chunk)
        for name, a, r in zip(NAMES, got, ref):
            assert a.dtype == (bc_dtype if name in ("dB", "dC") else torch.float32), name
            bar = 2.0 ** -7 if bc_dtype == torch.bfloat16 and name in ("dB", "dC") else 1e-4
            share = float((a.float() - r).abs().max()) / float(r.abs().max())
            assert share <= bar, (shape, name, share)
        # Autograd through ssd_scan: y as without grad, the kernel's gradients.
        leaves = [x.clone().requires_grad_() for x in (xdt, dA, bm, cm)]
        y = ssd_scan(*leaves, chunk=chunk)
        assert torch.equal(y.detach(), ssd_scan(xdt, dA, bm, cm, chunk=chunk))
        y.backward(dy)
        assert all(torch.equal(x.grad, g) for x, g in zip(leaves, got))
        with pytest.raises(RuntimeError, match="no backward"):
            ssd_scan(*leaves, chunk=chunk, return_state=True)
