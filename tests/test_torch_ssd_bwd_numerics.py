"""What the bf16 ``ssd_scan_bwd`` kernels compute, modelled on the CPU.

With bfloat16 B and C, ``csrc/ssd_scan_bwd.cu`` runs the scan's backward on
the tensor cores (``mma.sync``, bf16 operands, float32 sums).  Per (batch,
chunk), with ``cum`` a warp scan of dA (32 entries at a time), ``e =
exp(cum)``, ``w = exp(total - cum)``, ``L_ij = exp(cum_i - cum_j)`` (j <= i):

* ``G = C Bᵀ`` once per block of heads, a float32 sum of exact bf16
  products;
* per head ``dM = dy xdtᵀ`` and ``dxdt = Mᵀ dy`` (``M = G ∘ L``) with both
  float32 operands split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)``:
  ``hi·hi + hi·lo + lo·hi`` (``kSplitDm``, ``kSplitM``; one bf16 rounding of
  each operand when false);
* ``D = Σ_h dM ∘ L`` summed over the heads in order; ``dC = D B`` and ``dB
  = Dᵀ C`` once per (row, chunk), ``D`` split (two terms: B and C are
  exact);
* the state terms: ``g B`` and ``h C`` with the float32 state split (two
  terms); the heads' ``Σ_h e dyᵀ h`` into dC and ``Σ_h w xdtᵀ g`` into dB
  with both operands split (three terms); the states themselves from the
  state passes ``Σ_t (w u)_t ⊗ v_t`` with ``w u`` split (two terms);
* ``ddA`` the reverse warp scan of ``rowsum(dM ∘ M) - colsum(dM ∘ M)`` plus
  the state terms.

This file models that arithmetic in plain PyTorch and holds it against the
plain version ``ssd_scan_bwd_ref`` within the bar ``chip_smoke.py`` holds
the kernel to: each float32 gradient within ``SSD_BWD_F32_SHARE`` of its
largest value, bf16 dB/dC within ``SSD_BWD_BF16_SHARE``.  It pins that one
bf16 rounding of dM's or of Mᵀ dy's operands misses the float32 bar, which
is why the kernel splits them; the kernel's choice is read from its source.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref
from test_torch_ssd_numerics import bf16_mm as _mm
from test_torch_ssd_numerics import warp_scan

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "ssd_scan_bwd.cu"
SCAN_WIDTH = 32       # entries per step of the kernel's warp scans


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CS = _chip_smoke()
F32_SHARE, BF16_SHARE = _CS.SSD_BWD_F32_SHARE, _CS.SSD_BWD_BF16_SHARE


def _kernel_setting():
    """``split_dm`` and ``split_m`` as the kernel's source sets them."""
    text = SOURCE.read_text()
    found = {name: re.search(rf"constexpr bool {name} = (true|false);", text)
             for name in ("kSplitDm", "kSplitM")}
    assert all(found.values()), "the kernel no longer states its rounding of dM and M"
    return {"split_dm": found["kSplitDm"].group(1) == "true",
            "split_m": found["kSplitM"].group(1) == "true"}


KERNEL = _kernel_setting()

# Phase 24(c)'s scans (mamba2-2.7b: H=80, P=64, N=128; zamba2-7b: H=112,
# N=64; 512 tokens in two chunks of 256) cut to one row and a few heads,
# and two of phase 3's ragged grid shapes (Q, P and N off the 16-wide
# tiles, several chunks).
SHAPES = [(1, 512, 3, 64, 128, 256), (1, 512, 3, 64, 64, 256),
          (1, 130, 5, 64, 128, 65), (2, 33, 3, 18, 12, 11)]
NAMES = ("dxdt", "ddA", "dB", "dC")


def warp_scan_rev(a):
    """Reverse inclusive scan of ``a`` along its last axis as one warp does
    it: 32 entries at a time from the end, a Hillis-Steele scan downwards,
    plus the running carry."""
    q = a.shape[-1]
    out = torch.empty_like(a)
    carry = torch.zeros(a.shape[:-1])
    for base in range((q - 1) // SCAN_WIDTH * SCAN_WIDTH, -1, -SCAN_WIDTH):
        n = min(SCAN_WIDTH, q - base)
        v = torch.zeros(*a.shape[:-1], SCAN_WIDTH)
        v[..., :n] = a[..., base:base + n]
        step = 1
        while step < SCAN_WIDTH:
            shifted = torch.zeros_like(v)
            shifted[..., :-step] = v[..., step:]
            v = v + shifted
            step *= 2
        v = v + carry[..., None]
        out[..., base:base + n] = v[..., :n]
        carry = v[..., 0]
    return out


def bwd_kernel_model(xdt, dA, Bmat, Cmat, dy, *, chunk, split_dm=True, split_m=True):
    """The bf16 kernels' arithmetic: ``(dxdt, ddA, dB, dC)``, all float32
    (dB and dC before their one rounding to bf16).  ``split_dm`` and
    ``split_m`` False round dM's and Mᵀ dy's operands once to bf16."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    q = min(chunk, s)
    nc = s // q
    x = xdt.float().reshape(b, nc, q, h, p)
    g = dy.float().reshape(b, nc, q, h, p)
    bm = Bmat.float().reshape(b, nc, q, n)
    cm = Cmat.float().reshape(b, nc, q, n)
    cum = warp_scan(dA.float().reshape(b, nc, q, h).permute(0, 1, 3, 2))   # [b, c, h, q]
    total = cum[..., -1]
    e = torch.exp(cum)
    w = torch.exp(total[..., None] - cum)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, -torch.inf))
    G = torch.einsum("bcin,bcjn->bcij", cm, bm)                  # exact bf16 products
    e_t = e.permute(0, 1, 3, 2)[..., None]                       # [b, c, q, h, 1]
    w_t = w.permute(0, 1, 3, 2)[..., None]

    # The state passes: h entering each chunk, g leaving it, in float32
    # with w u split and v (B or C) exact.
    hs = [torch.zeros((b, h, p, n))]
    for c in range(nc - 1):
        upd = _mm("bqhp,bqn->bhpn", w_t[:, c] * x[:, c], bm[:, c], True, False)
        hs.append(hs[-1] * torch.exp(total[:, c])[..., None, None] + upd)
    gs = [torch.zeros((b, h, p, n))]
    for c in range(nc - 1, 0, -1):
        upd = _mm("bqhp,bqn->bhpn", e_t[:, c] * g[:, c], cm[:, c], True, False)
        gs.append(gs[-1] * torch.exp(total[:, c])[..., None, None] + upd)
    hs = torch.stack(hs, 1)                                      # [b, c, h, p, n]
    gs = torch.stack(gs[::-1], 1)

    dm = _mm("bcihp,bcjhp->bchij", g, x, split_dm, split_dm)
    mm = G[:, :, None] * L
    dG = dm * L
    pm = dm * mm
    # The state products with B/C exact and the state split.
    g_b = _mm("bcjn,bchpn->bcjhp", bm, gs, False, True)          # g B_j
    h_c = _mm("bcin,bchpn->bcihp", cm, hs, False, True)          # h C_i
    dx = w_t * g_b + _mm("bchij,bcihp->bcjhp", mm, g, split_m, split_m)
    ws = w * (x * g_b).sum(-1).permute(0, 1, 3, 2)                # [b, c, h, q]
    dcum = (pm.sum(-1) - pm.sum(-2) + e * (g * h_c).sum(-1).permute(0, 1, 3, 2) - ws)
    d_total = torch.exp(total) * (gs * hs).sum((-1, -2)) + ws.sum(-1)
    dcum[..., -1] += d_total
    ddA = warp_scan_rev(dcum).permute(0, 1, 3, 2)                 # [b, c, q, h]

    D = torch.zeros((b, nc, q, q))
    for hh in range(h):                                           # the heads in order
        D = D + dG[:, :, hh]
    dC = (_mm("bcij,bcjn->bcin", D, bm, True, False)
          + _mm("bcihp,bchpn->bcin", (e_t * g), hs, True, True))
    dB = (_mm("bcij,bcin->bcjn", D, cm, True, False)
          + _mm("bcjhp,bchpn->bcjn", (w_t * x), gs, True, True))
    return (dx.reshape(b, s, h, p), ddA.reshape(b, s, h), dB.reshape(b, s, n),
            dC.reshape(b, s, n))


def _inputs(shape, seed):
    """``chip_smoke.ssd_inputs``'s distributions (bf16 B/C) and a N(0, 1)
    cotangent, on the CPU."""
    b, s, h, p, n, _ = shape
    gen = torch.Generator().manual_seed(seed)
    xdt, dA, bm, cm = _CS.ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, "cpu")
    dy = torch.randn((b, s, h, p), generator=gen)
    return xdt, dA, bm, cm, dy


def _shares(got, ref):
    return {name: float((a.float() - r).abs().max()) / float(r.abs().max())
            for name, a, r in zip(NAMES, got, ref)}


_REF_CACHE: dict = {}


def _case(shape):
    """Inputs and the plain version's gradients (on upcast B/C), cached."""
    if shape not in _REF_CACHE:
        args = _inputs(shape, sum(shape))
        xdt, dA, bm, cm, dy = args
        _REF_CACHE[shape] = args, ssd_scan_bwd_ref(xdt, dA, bm.float(), cm.float(), dy,
                                                   chunk=shape[-1])
    return _REF_CACHE[shape]


def test_bars_are_chip_smokes():
    assert F32_SHARE == 1e-4 and BF16_SHARE == 2.0 ** -7


def test_reverse_warp_scan_is_a_reverse_running_sum():
    a = torch.randn(3, 2, 70, generator=torch.Generator().manual_seed(0))
    want = torch.flip(torch.cumsum(torch.flip(a, [-1]), -1), [-1])
    torch.testing.assert_close(warp_scan_rev(a), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_meets_the_bars(shape):
    (xdt, dA, bm, cm, dy), ref = _case(shape)
    got = bwd_kernel_model(xdt, dA, bm, cm, dy, chunk=shape[-1], **KERNEL)
    shares = _shares(got, ref)
    rounded = _shares((*got[:2], got[2].to(torch.bfloat16), got[3].to(torch.bfloat16)), ref)
    print(f"{shape}: max |model - plain| / max |plain| {shares}; bf16 dB/dC "
          f"{rounded['dB']!r}, {rounded['dC']!r}")
    for name in NAMES:
        assert shares[name] <= F32_SHARE, (name, shares[name])
    assert max(rounded["dB"], rounded["dC"]) <= BF16_SHARE


@pytest.mark.parametrize("split_dm,split_m,worse", [(False, True, "ddA"), (True, False, "dxdt")],
                         ids=["dM-once", "M-once"])
def test_one_bf16_rounding_breaks_the_bar(split_dm, split_m, worse):
    """At the cut mamba2 shape, one bf16 rounding of dM's operands misses
    ddA's float32 bar and one of Mᵀ dy's misses dxdt's; the split meets
    both on the same inputs."""
    shape = SHAPES[0]
    (xdt, dA, bm, cm, dy), ref = _case(shape)
    once = _shares(bwd_kernel_model(xdt, dA, bm, cm, dy, chunk=shape[-1], split_dm=split_dm,
                                     split_m=split_m), ref)
    print(f"split dM {split_dm}, split M {split_m}: {once}")
    assert once[worse] > F32_SHARE, once
    assert KERNEL == {"split_dm": True, "split_m": True}


def test_d_times_b_is_the_heads_sum():
    """D B, formed once per (row, chunk), equals Σ_h (dG_h B) within the
    float32 bar (float32 throughout: only the order of the sums differs)."""
    shape = SHAPES[0]
    (xdt, dA, bm, cm, dy), _ = _case(shape)
    b, s, h, p, n, q = shape
    nc = s // q
    cum = warp_scan(dA.reshape(b, nc, q, h).permute(0, 1, 3, 2))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, -torch.inf))
    dG = torch.einsum("bcihp,bcjhp->bchij", dy.reshape(b, nc, q, h, p),
                      xdt.reshape(b, nc, q, h, p)) * L
    bc = bm.float().reshape(b, nc, q, n)
    per_head = torch.einsum("bchij,bcjn->bchin", dG, bc).sum(2)
    once = torch.einsum("bcij,bcjn->bcin", dG.sum(2), bc)
    share = float((once - per_head).abs().max()) / float(per_head.abs().max())
    print(f"max |D B - Σ_h dG_h B| / max {share!r}")
    assert share <= F32_SHARE
