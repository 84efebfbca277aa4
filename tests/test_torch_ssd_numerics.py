"""What the bf16 ``ssd_scan`` kernels compute, modelled on the CPU.

With bfloat16 B and C, ``csrc/ssd_scan.cu`` runs on the tensor cores.
With more than one chunk (or the final state asked for) the state kernel
runs first and forms the state entering each chunk, ``h <- exp(total) h +
Σ_j (exp(total - cum_j) xdt_j)ᵀ B_j`` with the weighted xdt split (two
terms) and B exact.  Then the chunk kernel forms y: ``cum`` is a warp scan
of dA, 32 entries at a time; a head's accumulators start, from the second
chunk on, at the carried-state term ``exp(cum_i) C_i·h_cᵀ`` (C exact, h_c
split: ``kSplitH``, two terms), else at zero; then, 32 tokens (a slab) at
a time, C·Bᵀ is a float32 sum of exact bf16 products, the scores are
``C_i·B_j · exp(cum_i - cum_j)`` in float32 under the causal mask, both
the scores and xdt are split into ``hi = bf16(x)`` and ``lo = bf16(x -
hi)``, and ``hi·hi + hi·lo + lo·hi`` joins the float32 accumulators.  This
file models that arithmetic in plain PyTorch, in that order, and holds it
against the plain version ``ssd_scan_ref`` and the sequential recurrence
within the bars that ``chip_smoke.py`` holds the kernel to (``SSD_TOL``,
``SSD_SEQ_TOL``), the final state too.  It also pins that rounding the
scores, xdt or the state once to bf16 breaks the first bar, which is why
the kernels split all three; the kernel's choice for the state is read
from its source.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models.ssm import ssd_sequential_ref
from test_torch_ssm import SSD_SHAPES, _ssd_inputs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
SCAN_WIDTH = 32       # entries per step of the kernel's warp scan of dA
SLAB = 32             # tokens per step of the chunk kernel's accumulation


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
# Phase 24(c)'s scans (mamba2-2.7b, zamba2-7b: 512 tokens in two chunks of
# 256) cut to one row and three heads, and phase 3's three chunks of 128.
TRAIN = [(1, 512, 3, 64, 128, 256), (1, 512, 3, 64, 64, 256), (1, 384, 4, 64, 128, 128)]


def _split_h():
    """``kSplitH`` as the kernel's source sets it."""
    found = re.search(r"constexpr bool kSplitH = (true|false);", SOURCE.read_text())
    assert found, "the kernel no longer states its rounding of the state"
    return found.group(1) == "true"


SPLIT_H = _split_h()


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


def split(x):
    """``(hi, lo)``: ``hi = bf16(x)``, ``lo = bf16(x - hi)``, as float32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def bf16_mm(eq, a, b, split_a, split_b):
    """``einsum(eq, a, b)`` as the kernels' bf16 products form it: each
    split operand ``hi + lo``, each unsplit one rounded once (or exact,
    where it is already bf16); a split pair drops ``lo·lo``."""
    a_hi, a_lo = split(a) if split_a else (_bf16(a), None)
    b_hi, b_lo = split(b) if split_b else (_bf16(b), None)
    out = torch.einsum(eq, a_hi, b_hi)
    if a_lo is not None:
        out = out + torch.einsum(eq, a_lo, b_hi)
    if b_lo is not None:
        out = out + torch.einsum(eq, a_hi, b_lo)
    return out


def kernel_model(xdt, dA, Bmat, Cmat, *, chunk, split_scores=True, split_x=True, split_h=True,
                 return_state=False):
    """The bf16 kernels' arithmetic: ``y [B, S, H, P]`` in float32, or
    with ``return_state`` ``(y, h_final [B, H, P, N])``.
    ``split_scores``/``split_x``/``split_h`` False round that operand once
    to bf16."""
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
    # The state kernel: the state entering each chunk (and, with
    # return_state, the one after the last) in float32, its update
    # exp(total - cum_j) xdt_j split (two terms) against B exact.
    total = cum[..., -1]                                                    # [B, c, H]
    w_end = torch.exp(total[..., None] - cum).permute(0, 1, 3, 2)[..., None]
    states = [torch.zeros((b, h, p, n))]
    for c in range(nc if return_state else nc - 1):
        upd = bf16_mm("bqhp,bqn->bhpn", w_end[:, c] * xc[:, c], bc[:, c], True, False)
        states.append(states[-1] * torch.exp(total[:, c])[..., None, None] + upd)
    # The chunk kernel: from the second chunk on the accumulators start at
    # exp(cum_i) C_i . h_c^T (C exact, h_c split: two terms), then each
    # slab's hi.hi + hi.lo + lo.hi joins them.
    ys = []
    for c in range(nc):
        if c > 0:
            decay = torch.exp(cum[:, c]).transpose(1, 2)[..., None]        # [B, Q, H, 1]
            acc = bf16_mm("bin,bhpn->bihp", cc[:, c], states[c], False, split_h) * decay
        else:
            acc = torch.zeros((b, q, h, p))
        for j0 in range(0, q, SLAB):
            js = slice(j0, j0 + SLAB)
            acc = acc + torch.einsum("bhij,bjhp->bihp", s_hi[:, c, ..., js], x_hi[:, c, js])
            if split_x:
                acc = acc + torch.einsum("bhij,bjhp->bihp", s_hi[:, c, ..., js], x_lo[:, c, js])
            if split_scores:
                acc = acc + torch.einsum("bhij,bjhp->bihp", s_lo[:, c, ..., js], x_hi[:, c, js])
        ys.append(acc)
    out = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return (out, states[-1]) if return_state else out


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


@pytest.mark.parametrize("shape", DRIVEN + SSD_SHAPES + TRAIN, ids=lambda s: "x".join(map(str, s)))
def test_split_model_meets_the_bars(shape):
    args = _inputs(shape)
    q = shape[-1]
    out, state = kernel_model(*args, chunk=q, split_h=SPLIT_H, return_state=True)
    ref, ref_state = ssd_scan_ref(*args, chunk=q, return_state=True)
    seq, seq_state = ssd_sequential_ref(*args)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.equal(out, kernel_model(*args, chunk=q, split_h=SPLIT_H))
    bad, worst = _outside(out, ref, SSD_TOL)
    bad_seq, worst_seq = _outside(out, seq, SSD_SEQ_TOL)
    bad_state, worst_state = _outside(state, ref_state, SSD_TOL)
    bad_seq_state, _ = _outside(state, seq_state, SSD_SEQ_TOL)
    print(f"{shape}: max |model - plain| {worst!r}, max |model - sequential| {worst_seq!r}, "
          f"final state max |model - plain| {worst_state!r}")
    assert bad == 0, f"{bad} of {out.numel()} outside SSD_TOL (max |err| {worst})"
    assert bad_seq == 0, f"{bad_seq} of {out.numel()} outside SSD_SEQ_TOL (max |err| {worst_seq})"
    assert bad_state == 0 and bad_seq_state == 0, (bad_state, bad_seq_state)


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


@pytest.mark.parametrize("shape", TRAIN[:2], ids=lambda s: "x".join(map(str, s)))
def test_one_bf16_rounding_of_the_state_breaks_the_bar(shape):
    """At the cut training shapes, the state entering the second chunk
    rounded once to bf16 in exp(cum_i) C_i·hᵀ misses SSD_TOL against the
    plain scan and SSD_SEQ_TOL against the recurrence; the split (what the
    kernel ships) meets both on the same inputs."""
    args = _inputs(shape)
    q = shape[-1]
    ref = ssd_scan_ref(*args, chunk=q)
    seq, _ = ssd_sequential_ref(*args)
    once = kernel_model(*args, chunk=q, split_h=False)
    bad_once, worst = _outside(once, ref, SSD_TOL)
    bad_seq, _ = _outside(once, seq, SSD_SEQ_TOL)
    print(f"{shape}: the state rounded once: {bad_once} of {ref.numel()} outside SSD_TOL, "
          f"{bad_seq} outside SSD_SEQ_TOL (max |err| {worst!r})")
    assert bad_once > 0 and bad_seq > 0
    assert _outside(kernel_model(*args, chunk=q), ref, SSD_TOL)[0] == 0
    assert SPLIT_H
