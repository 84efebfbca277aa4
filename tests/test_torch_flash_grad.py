"""The gradient of ``flash_attention`` in the PyTorch/CUDA port.

* autograd of the plain version (the CPU training path) against
  ``jax.grad`` of the reference's ``chunked_attention``, which the JAX
  package differentiates when it trains (float32, causal and not, GQA);
* the plain versions of the forward's log-sum-exp output and of the
  backward kernel (``flash_attention_lse_ref``, ``flash_attention_bwd_ref``)
  against ``torch.logsumexp`` and autograd;
* the guard of the kernels without a backward (``refuse_grad``);
* on a card (``cuda``-marked), the backward kernel against its plain
  version (and a second call bit-equal to the first), the ``lse`` output,
  autograd through ``flash_attention``, the bf16 kernels at query-head
  groups a 64-row tile does not divide or hold, and three calls bit-equal
  while another stream's work shares the card.

JAX is imported by the ``jx`` fixture only, so the file also runs on the
card's machine, which has no JAX (``pytest -m cuda``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

torch.set_num_threads(2)

# (B, S, Hq, Hkv, D): GQA 4/2 and 8/2, MHA, an off-tile length.
SHAPES = [(2, 24, 4, 2, 16), (1, 33, 8, 2, 32), (2, 17, 4, 4, 16)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    jax = pytest.importorskip("jax")
    from repro.models.layers import chunked_attention

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, chunked_attention=chunked_attention)


def _inputs(seed, b, s, hq, hkv, d):
    g = np.random.default_rng(seed)
    return (g.normal(size=(b, s, hq, d)).astype(np.float32),
            g.normal(size=(b, s, hkv, d)).astype(np.float32),
            g.normal(size=(b, s, hkv, d)).astype(np.float32),
            g.normal(size=(b, s, hq, d)).astype(np.float32))


def _torch_grads(q, k, v, dout, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)        # CPU: the plain version
    out.backward(torch.from_numpy(dout))
    return out.detach(), qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_of_the_plain_version_matches_jax_grad(jx, shape, causal):
    q, k, v, dout = _inputs(1, *shape)
    jq, jk, jv = (jx.jnp.asarray(x) for x in (q, k, v))

    def f(q, k, v):
        out = jx.chunked_attention(q, k, v, causal=causal, chunk=8)
        return jx.jnp.sum(out * dout)

    ref = jx.jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    out, *got = _torch_grads(q, k, v, dout, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jx.chunked_attention(
        jq, jk, jv, causal=causal, chunk=8)), rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_and_lse_match_autograd(shape, causal):
    b, s, hq, hkv, d = shape
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(2, *shape))
    out, *grads = _torch_grads(q.numpy(), k.numpy(), v.numpy(), dout.numpy(), causal)
    lse = flash_attention_lse_ref(q, k, causal=causal)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(hq // hkv, dim=2))
    scores = scores / np.sqrt(d)
    if causal:
        scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), rtol=1e-6, atol=1e-6)
    plain = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), plain, grads):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6, msg=name)


def test_plain_backward_keeps_the_input_dtype():
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(3, 1, 9, 4, 2, 16))
    out = flash_attention_ref(q, k, v)
    lse = flash_attention_lse_ref(q, k)
    for g in flash_attention_bwd_ref(q, k, v, out, dout, lse):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())


def test_refuse_grad_raises_only_when_a_gradient_is_needed():
    """The shared check of the six kernels without a backward."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: the CUDA kernel has no backward"):
        refuse_grad("ssd_scan", x, None, 3)
    refuse_grad("ssd_scan", x.detach(), torch.ones(2))
    with torch.no_grad():
        refuse_grad("ssd_scan", x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops

    dev = torch.device("cuda")
    for causal in (True, False):
        for shape in SHAPES + [(2, 160, 32, 8, 128), (1, 70, 32, 32, 112), (2, 40, 8, 2, 64),
                               (2, 96, 16, 2, 32)]:
            q, k, v, dout = (torch.from_numpy(x).to(dev, dtype) for x in _inputs(4, *shape))
            out, lse = flash_ops._forward(q, k, v, causal, with_lse=True)
            assert torch.equal(out, flash_attention(q, k, v, causal=causal))
            torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, causal=causal),
                                       rtol=5e-5, atol=5e-5)
            before = LAUNCHES["flash_attention_bwd"]
            got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
            assert LAUNCHES["flash_attention_bwd"] == before + 1
            again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
            ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                          dout.float(), lse, causal=causal)
            for a, r in zip(got, ref):
                assert a.dtype == dtype
                if dtype == torch.float32:
                    torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
                else:
                    assert float((a.float() - r).abs().max()) <= 2.0 ** -6 * float(r.abs().max())


@pytest.mark.cuda
def test_cuda_autograd_goes_through_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention import decode_attention

    q, k, v, dout = _inputs(5, 2, 48, 8, 2, 64)
    cpu_out, *cpu_grads = _torch_grads(q, k, v, dout, True)
    dev = torch.device("cuda")
    qt, kt, vt = (torch.from_numpy(x).to(dev).requires_grad_() for x in (q, k, v))
    before = dict(LAUNCHES)
    out = flash_attention(qt, kt, vt)
    out.backward(torch.from_numpy(dout).to(dev))
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    for a, r in zip((qt.grad, kt.grad, vt.grad), cpu_grads):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(qt[:, 0].detach().requires_grad_(), kt.detach(), vt.detach(), 48)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 40, 8, 128), (2, 96, 16, 1, 64), (1, 60, 71, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_bf16_at_groups_a_row_tile_does_not_divide_or_hold(shape):
    """G = 5 (whole positions and zero rows in a 64-row tile), G = 16 at
    D=64 and G = 71 (past a tile: the mma.sync bodies): the forward's out
    equal with and without lse and within the bf16 bar, the backward within
    its bar and a second call bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops

    dev = torch.device("cuda")
    q, k, v, dout = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in _inputs(6, *shape))
    out, lse = flash_ops._forward(q, k, v, True, with_lse=True)
    assert torch.equal(out, flash_attention(q, k, v))
    ref_out = flash_attention_ref(q.float(), k.float(), v.float())
    assert bool(((out.float() - ref_out).abs() <= 1e-5 + 2.0 ** -7 * ref_out.abs()).all())
    got = flash_attention_bwd(q, k, v, out, dout, lse)
    again = flash_attention_bwd(q, k, v, out, dout, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), dout.float(), lse)
    for a, r in zip(got, ref):
        assert float((a.float() - r).abs().max()) <= 2.0 ** -6 * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 32, 8, 128), (8, 512, 32, 32, 112)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_backward_repeats_bit_equal_under_concurrent_work(shape):
    """Phase 24's shape and zamba2's D=112: three bf16 backward calls give
    the same bits while a second stream's matrix products take SMs, so
    that the kernels' blocks run in another order each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops

    b, s, hq, hkv, d = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v, dout = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                     for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    out, lse = flash_ops._forward(q, k, v, True, with_lse=True)
    side = torch.cuda.Stream()
    x = torch.randn((4096, 4096), generator=gen, device=dev)
    got, busy = [], []
    for n in range(3):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            busy += [x @ x for _ in range(n + 1)]   # a different load beside each call
        got.append(flash_attention_bwd(q, k, v, out, dout, lse))
    torch.cuda.synchronize()
    for again in got[1:]:
        assert all(torch.equal(a, r) for a, r in zip(got[0], again))
