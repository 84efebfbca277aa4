"""The states that the SSD scan's forward hands to its backward, in the
PyTorch/CUDA port.

* ``ssd_chunk_states_ref`` (the state entering each chunk) against the JAX
  package's ``repro.models.ssm.ssd_chunked`` run on each prefix of c·Q
  tokens, whose final state is the state entering chunk c;
* ``ssd_scan_bwd_ref`` given those states equals the call that recomputes
  them, bit for bit;
* ``SsdScan`` with its ``KERNEL`` hook on the plain versions hands the
  forward's states to the backward, and its gradients equal autograd of
  ``ssd_scan_ref``;
* on a card (``cuda``-marked), the forward kernel's states against the
  plain version and the backward kernel given them bit-equal to the call
  that recomputes them.

Tolerances: against the JAX package, ``test_torch_ssm.py``'s bar for the
scans (1e-5: float32 sums in another order); against autograd, and the
states on the card, ``test_torch_ssd_grad.py``'s and ``chip_smoke.py``'s
bars.

JAX is imported by the ``jx`` fixture only, so the file also runs on the
card's machine, which has no JAX (``pytest -m cuda``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_chunk_states_ref, ssd_scan_bwd_ref, ssd_scan_ref
from test_torch_ssd_grad import NAMES, SSD_SHAPES, TORCH_TOL, _assert_grads, _autograd, \
    _ssd_inputs, _tensors

torch.set_num_threads(2)

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# The shapes of SSD_SHAPES with more than one chunk, and a ragged one.
MULTI = [shape for shape in SSD_SHAPES if shape[1] > shape[-1]] + [(1, 45, 5, 16, 8, 15)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    from repro.models import ssm

    return types.SimpleNamespace(jnp=jax.numpy, ssm=ssm)


@pytest.mark.parametrize("shape", MULTI, ids=lambda s: "x".join(map(str, s)))
def test_chunk_states_match_the_reference_on_prefixes(jx, shape):
    *dims, chunk = shape
    xdt, dA, bm, cm, _ = _ssd_inputs(8, *dims)
    states = ssd_chunk_states_ref(*(torch.from_numpy(x) for x in (xdt, dA, bm, cm)), chunk)
    b, s, h, p, n = dims
    assert tuple(states.shape) == (b, s // chunk, h, p, n) and states.dtype == torch.float32
    assert torch.equal(states[:, 0], torch.zeros_like(states[:, 0]))
    for c in range(1, s // chunk):
        t = c * chunk
        _, want = jx.ssm.ssd_chunked(*(jx.jnp.asarray(x[:, :t]) for x in (xdt, dA, bm, cm)),
                                     chunk)
        np.testing.assert_allclose(states[:, c].numpy(), np.asarray(want), **SCAN_TOL,
                                   err_msg=f"state entering chunk {c}")


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MULTI, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_takes_the_states(shape, bc_dtype):
    """Given the states, the plain backward's gradients are the bits of the
    call that recomputes them; each state is the final state of
    ``ssd_scan_ref`` over the tokens before its chunk, bit for bit."""
    *dims, chunk = shape
    xdt, dA, bm, cm, dy = _tensors(_ssd_inputs(9, *dims), bc_dtype)
    states = ssd_chunk_states_ref(xdt, dA, bm, cm, chunk)
    got = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk, states=states)
    want = ssd_scan_bwd_ref(xdt, dA, bm, cm, dy, chunk=chunk)
    for name, a, w in zip(NAMES, got, want):
        assert torch.equal(a, w), name
    for c in range(1, states.shape[1]):
        _, h_c = ssd_scan_ref(*(x[:, :c * chunk] for x in (xdt, dA, bm, cm)), chunk=chunk,
                              return_state=True)
        assert torch.equal(h_c, states[:, c]), c


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_hands_the_states_to_the_backward(monkeypatch, bc_dtype):
    b, s, h, p, n, chunk = 2, 96, 3, 16, 8, 32
    xdt, dA, bm, cm, dy = _tensors(_ssd_inputs(10, b, s, h, p, n), bc_dtype)
    seen = {}

    def forward(*args, chunk, keep_states):
        seen["kept"] = ssd_chunk_states_ref(*args, chunk)
        return ssd_scan_ref(*args, chunk=chunk), seen["kept"]

    def backward(*args, chunk, states):
        seen["given"] = states
        return ssd_scan_bwd_ref(*args, chunk=chunk, states=states)

    monkeypatch.setattr(ssd_ops.KERNEL, "forward", forward)
    monkeypatch.setattr(ssd_ops.KERNEL, "backward", backward)
    leaves = [x.clone().requires_grad_() for x in (xdt, dA, bm, cm)]
    y = ssd_ops.SsdScan.apply(*leaves, chunk)
    y.backward(dy)
    assert seen["given"] is seen["kept"]
    got = [x.grad for x in leaves]
    want = _autograd(xdt, dA, bm, cm, dy, chunk)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, bc_dtype, bc_dtype]
    _assert_grads(got[:2], want[:2], TORCH_TOL)
    for name, a, w in zip(NAMES[2:], got[2:], want[2:]):
        tol = TORCH_TOL if bc_dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-6)
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(), **tol, err_msg=name)


@pytest.mark.cuda
def test_cuda_forward_states_feed_the_backward():
    """The bf16 forward kernel's states against the plain version (entries
    1 .. nc - 1, within chip_smoke's SSD_TOL), none kept for float32 or one
    chunk, and the backward kernel given them bit-equal to the call that
    recomputes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    dev = torch.device("cuda")
    for shape in [(2, 512, 80, 64, 128, 256), (2, 512, 112, 64, 64, 256), (2, 33, 3, 18, 12, 11),
                  (1, 256, 5, 128, 256, 64)]:
        *dims, chunk = shape
        xdt, dA, bm, cm, dy = (x.to(dev) for x in _tensors(_ssd_inputs(11, *dims),
                                                          torch.bfloat16))
        y, states = ssd_ops._forward(xdt, dA, bm, cm, chunk=chunk, keep_states=True)
        assert torch.equal(y, ssd_ops._forward(xdt, dA, bm, cm, chunk=chunk))
        ref = ssd_chunk_states_ref(xdt, dA, bm.float(), cm.float(), chunk)
        diff = (states[:, 1:] - ref[:, 1:]).abs()
        assert bool((diff <= 1e-4 + 1e-4 * ref[:, 1:].abs()).all()), (shape, float(diff.max()))
        given = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=chunk, states=states)
        again = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=chunk)
        assert all(torch.equal(a, w) for a, w in zip(given, again)), shape
        _, none = ssd_ops._forward(xdt, dA, bm.float(), cm.float(), chunk=chunk,
                                   keep_states=True)
        assert none is None
