"""What the bf16 ``ssd_scan`` kernel computes, modelled on the CPU.

With bfloat16 B and C, ``csrc/ssd_scan.cu`` runs the part of y inside each
chunk on the tensor cores: C·Bᵀ is a float32 sum of exact bf16 products;
``cum`` is a warp scan of dA, 32 entries at a time; each head's scores are
``C_i·B_j · exp(cum_i - cum_j)`` in float32 under the causal mask; both the
scores and xdt are split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)``,
and y is ``hi·hi + hi·lo + lo·hi`` accumulated in float32.  With more than
one chunk the state pass adds ``exp(cum_i) C_i·hᵀ`` and carries the state in
float32.  This file models that arithmetic in plain PyTorch and holds it
against the plain version ``ssd_scan_ref`` and the sequential recurrence
within the bars that ``chip_smoke.py`` holds the kernel to (``SSD_TOL``,
``SSD_SEQ_TOL``).  It also pins that rounding the scores or xdt once to
bf16 breaks the first bar, which is why the kernel splits both.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models.ssm import ssd_sequential_ref
from test_torch_ssm import SSD_SHAPES, _ssd_inputs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCAN_WIDTH = 32       # entries per step of the kernel's warp scan of dA


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CS = _chip_smoke()
SSD_TOL, SSD_SEQ_TOL = _CS.SSD_TOL, _CS.SSD_SEQ_TOL
# Phase 13's scan per row (mamba2-2.7b: Q=160, P=64, N=128) and phase 14's
# (zamba2-7b: N=64), cut to a few rows and heads.
DRIVEN = [(4, 160, 8, 64, 128, 160), (2, 160, 8, 64, 64, 160)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def warp_scan(a):
    """Inclusive scan of ``a`` along its last axis as one warp does it: a
    Hillis-Steele scan of 32 entries at a time, plus the running carry."""
    q = a.shape[-1]
    out = torch.empty_like(a)
    carry = torch.zeros(a.shape[:-1])
    for base in range(0, q, SCAN_WIDTH):
        n = min(SCAN_WIDTH, q - base)
        v = torch.zeros(*a.shape[:-1], SCAN_WIDTH)
        v[..., :n] = a[..., base:base + n]
        step = 1
        while step < SCAN_WIDTH:
            shifted = torch.zeros_like(v)
            shifted[..., step:] = v[..., :-step]
            v = v + shifted
            step *= 2
        v = v + carry[..., None]
        out[..., base:base + n] = v[..., :n]
        carry = v[..., -1]
    return out


def kernel_model(xdt, dA, Bmat, Cmat, *, chunk, split_scores=True, split_x=True):
    """The bf16 kernel's arithmetic: ``y [B, S, H, P]`` in float32.
    ``split_scores``/``split_x`` False round that operand once to bf16."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    q = min(chunk, s)
    nc = s // q
    xc = xdt.float().reshape(b, nc, q, h, p)
    cum = warp_scan(dA.float().reshape(b, nc, q, h).permute(0, 1, 3, 2))   # [B, c, H, Q]
    bc = Bmat.float().reshape(b, nc, q, n)
    cc = Cmat.float().reshape(b, nc, q, n)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)          # exact bf16 products
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    scores = torch.where(tri, cb[:, :, None] * torch.exp(cum[..., :, None] - cum[..., None, :]),
                         0.0)                              # [B, c, H, Q, Q]
    s_hi, x_hi = _bf16(scores), _bf16(xc)
    s_lo, x_lo = _bf16(scores - s_hi), _bf16(xc - x_hi)
    y = torch.einsum("bchij,bcjhp->bcihp", s_hi, x_hi)
    if split_x:
        y = y + torch.einsum("bchij,bcjhp->bcihp", s_hi, x_lo)
    if split_scores:
        y = y + torch.einsum("bchij,bcjhp->bcihp", s_lo, x_hi)
    # The state pass, in float32 (the CUDA-core body's arithmetic).
    state = torch.zeros((b, h, p, n))
    ys = []
    for c in range(nc):
        decay = torch.exp(cum[:, c]).transpose(1, 2)[..., None]            # [B, Q, H, 1]
        ys.append(y[:, c] + torch.einsum("bin,bhpn->bihp", cc[:, c], state) * decay)
        total = cum[:, c, :, -1]
        w_end = torch.exp(total[..., None] - cum[:, c])                    # [B, H, Q]
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqhp,bhq,bqn->bhpn", xc[:, c], w_end, bc[:, c])
    return torch.stack(ys, dim=1).reshape(b, s, h, p)


def _inputs(shape):
    b, s, h, p, n, _ = shape
    xdt, dA, bm, cm = (torch.from_numpy(x) for x in _ssd_inputs(sum(shape), b, s, h, p, n))
    return xdt, dA, bm.to(torch.bfloat16), cm.to(torch.bfloat16)


def _outside(out, ref, tol):
    """Elements outside ``atol + rtol |ref|``, and the largest |out - ref|."""
    diff = (out - ref).abs()
    return int((diff > tol["atol"] + tol["rtol"] * ref.abs()).sum()), float(diff.max())


def test_bars_are_chip_smokes():
    assert SSD_TOL == dict(atol=1e-4, rtol=1e-4)
    assert SSD_SEQ_TOL == dict(atol=2e-4, rtol=2e-4)


def test_warp_scan_is_a_running_sum():
    a = -torch.nn.functional.softplus(torch.randn(3, 2, 70, generator=torch.Generator().manual_seed(0)))
    torch.testing.assert_close(warp_scan(a), torch.cumsum(a, -1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape", DRIVEN + SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_model_meets_the_bars(shape):
    args = _inputs(shape)
    q = shape[-1]
    out = kernel_model(*args, chunk=q)
    ref = ssd_scan_ref(*args, chunk=q)
    seq, _ = ssd_sequential_ref(*args)
    assert out.shape == ref.shape and out.dtype == torch.float32
    bad, worst = _outside(out, ref, SSD_TOL)
    bad_seq, worst_seq = _outside(out, seq, SSD_SEQ_TOL)
    print(f"{shape}: max |model - plain| {worst!r}, max |model - sequential| {worst_seq!r}")
    assert bad == 0, f"{bad} of {out.numel()} outside SSD_TOL (max |err| {worst})"
    assert bad_seq == 0, f"{bad_seq} of {out.numel()} outside SSD_SEQ_TOL (max |err| {worst_seq})"


@pytest.mark.parametrize("split_scores,split_x", [(False, True), (True, False), (False, False)],
                         ids=["scores-once", "xdt-once", "both-once"])
def test_one_bf16_rounding_breaks_the_bar(split_scores, split_x):
    """At phase 13's per-row shape, one bf16 rounding of the scores or of
    xdt misses SSD_TOL on many outputs; the split meets it on the same
    inputs."""
    args = _inputs(DRIVEN[0])
    ref = ssd_scan_ref(*args, chunk=DRIVEN[0][-1])
    bad_split, _ = _outside(kernel_model(*args, chunk=DRIVEN[0][-1]), ref, SSD_TOL)
    bad_once, worst = _outside(kernel_model(*args, chunk=DRIVEN[0][-1],
                                            split_scores=split_scores, split_x=split_x),
                               ref, SSD_TOL)
    print(f"split scores {split_scores}, split xdt {split_x}: {bad_once} of {ref.numel()} "
          f"outside SSD_TOL (max |err| {worst!r})")
    assert bad_split == 0
    assert bad_once > ref.numel() // 10, (bad_once, ref.numel())
