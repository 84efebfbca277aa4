"""What the bf16 flash-attention backward kernel computes, modelled on the CPU.

``csrc/flash_attention_bwd.cu`` runs the bf16 backward on the tensor cores:
the scores ``s = q·k`` and ``dp = do·v`` are float32 sums of exact bf16
products; ``p = exp2(fma(s, scale·log2 e, -lse·log2 e))`` in float32 under
the causal mask (the MUFU ``ex2.approx.ftz``: within ~2^-22 of exp2, 0
below 2^-126); ``D = Σ do·o`` and ``ds = p (dp - D)`` in float32; then
``p`` and ``ds`` enter the bf16 products ``dv = pᵀ do``, ``dk = dsᵀ q`` and
``dq = ds k``, each either rounded once to bf16 or split into ``hi =
bf16(x)`` and ``lo = bf16(x - hi)``; the sums are float32, ``dk`` and ``dq``
are scaled by ``1/sqrt(D)`` and every gradient is rounded once to bf16.
This file models that arithmetic in plain PyTorch and holds it against the
plain version ``flash_attention_bwd_ref`` (which ``test_torch_flash_grad.py``
holds against ``jax.grad`` of the reference) within the bar ``chip_smoke.py``
holds the kernel to: each gradient's largest error at most
``FLASH_BWD_BF16_SHARE`` of its largest value.  The kernel's rounding is
read from its source (``kSplitP``, ``kSplitDs``), so the model tested is the
kernel's.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
LOG2E = 1.4426950408889634


def _bar():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FLASH_BWD_BF16_SHARE


BAR = _bar()


def _key_tile():
    """Keys per K/V tile of the wgmma body's dq kernel, whose products are
    added to dq tile after tile."""
    found = re.search(r"constexpr int kDqKeys = (\d+);", SOURCE.read_text())
    assert found, "the kernel no longer states its key tile"
    return int(found.group(1))


def _kernel_setting():
    """``split_p`` and ``split_ds`` as the kernel's source sets them."""
    text = SOURCE.read_text()
    found = {name: re.search(rf"constexpr bool {name} = (true|false);", text)
             for name in ("kSplitP", "kSplitDs")}
    assert all(found.values()), "the kernel no longer states its rounding of p and ds"
    return {"split_p": found["kSplitP"].group(1) == "true",
            "split_ds": found["kSplitDs"].group(1) == "true"}


KERNEL = _kernel_setting()
KEY_TILE = _key_tile()

# Phase 3's bf16 shapes (B, S, Hq, Hkv, D, causal), cut in batch and heads
# to a CPU's size; S, D and the head ratio kept.
SHAPES = [(2, 160, 8, 2, 64, True), (1, 33, 4, 1, 16, True), (2, 7, 8, 8, 64, True),
          (2, 100, 8, 2, 128, False), (1, 160, 32, 32, 112, True),
          (1, 512, 8, 2, 128, True), (2, 96, 16, 2, 32, True)]


def _f32(x):
    return x.to(torch.float32)


def _rounded(x, split):
    """``x`` as the kernel feeds it to a bf16 product: ``bf16(x)``, or
    ``hi + lo`` with ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = _f32(x.to(torch.bfloat16))
    if not split:
        return hi
    return hi + _f32((x - hi).to(torch.bfloat16))


def bwd_kernel_model(q, k, v, out, dout, lse, *, split_p, split_ds, causal=True):
    """``(dq, dk, dv)`` by the bf16 kernel's arithmetic and roundings."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = np.float32(1.0 / math.sqrt(d))
    scale2 = float(np.float32(scale * np.float32(LOG2E)))
    qf = _f32(q).reshape(b, sq, hkv, g, d)
    dof = _f32(dout).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, _f32(k))
    lse2 = _f32(lse).reshape(b, hkv, g, sq) * np.float32(LOG2E)
    # fma(s, scale2, -lse2): one rounding of the exact product and sum.
    x = (s.double() * scale2 - lse2.double()[..., None]).float()
    p = torch.exp2(x)
    p = torch.where(p < 2.0 ** -126, 0.0, p)
    if causal:
        mask = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        p = torch.where(mask, p, 0.0)
    delta = (_f32(dout) * _f32(out)).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, _f32(v))
    ds = p * (dp - delta[..., None])
    pr, dsr = _rounded(p, split_p), _rounded(ds, split_ds)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pr, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dsr, qf) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsr, _f32(k)) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _inputs(seed, b, s, hq, hkv, d, causal):
    """bf16 q, k, v, dout from a numpy seed, the plain forward's bf16 ``out``
    and its float32 ``lse``, as phase 3 makes them on the card."""
    rs = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rs.normal(size=shape).astype(np.float32))
                     .to(torch.bfloat16)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    return (q, k, v, flash_attention_ref(q, k, v, causal=causal), dout,
            flash_attention_lse_ref(q, k, causal=causal))


def _shares(got, q, k, v, out, dout, lse, causal):
    """Each gradient's max |got - plain| over its max |plain|, as phase 3."""
    ref = flash_attention_bwd_ref(_f32(q), _f32(k), _f32(v), _f32(out), _f32(dout), lse,
                                  causal=causal)
    return [float((_f32(x) - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for x, r in zip(got, ref)]


def test_bar_is_chip_smokes():
    assert BAR == 2.0 ** -6


def test_kernel_rounds_p_and_ds_once():
    """The rounding the model below holds to the bar is the kernel's."""
    assert KERNEL == {"split_p": False, "split_ds": False}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_meets_the_bf16_bar(shape):
    *dims, causal = shape
    inputs = _inputs(sum(dims), *dims, causal)
    got = bwd_kernel_model(*inputs, causal=causal, **KERNEL)
    for x, want in zip(got, inputs[:3]):
        assert x.dtype == torch.bfloat16 and x.shape == want.shape
        assert bool(torch.isfinite(_f32(x)).all())
    shares = _shares(got, *inputs, causal)
    # Well inside: the final rounding of each gradient to bf16 alone may
    # take 2^-8 of its largest value, one rounding of p and ds about as
    # much again.
    assert max(shares) <= BAR / 2, shares


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[5:6], ids=lambda s: "x".join(map(str, s)))
def test_one_rounding_costs_little_against_the_split(shape):
    """Splitting p and ds into hi + lo would buy little: one rounding of
    each adds at most 2^-8 of each gradient's largest value to the split
    model's error, which the bar leaves room for four times over, so the
    kernel spends no second product on them."""
    *dims, causal = shape
    inputs = _inputs(7 + sum(dims), *dims, causal)
    once = _shares(bwd_kernel_model(*inputs, causal=causal, split_p=False, split_ds=False),
                   *inputs, causal)
    split = _shares(bwd_kernel_model(*inputs, causal=causal, split_p=True, split_ds=True),
                    *inputs, causal)
    for a, b in zip(once, split):
        assert a <= b + 2.0 ** -8, (once, split)


def tiled_dq_model(q, k, v, out, dout, lse, *, causal=True, tile=None):
    """``dq`` as the wgmma body's dq kernel sums it: each key tile's float32
    partial ``ds k`` over its ``tile`` keys (ds rounded once to bf16), the
    partials added one after another in ascending key-tile order in
    float32, the sum scaled by ``1/sqrt(D)`` and rounded once to bf16."""
    tile = KEY_TILE if tile is None else tile
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = np.float32(1.0 / math.sqrt(d))
    scale2 = float(np.float32(scale * np.float32(LOG2E)))
    qf = _f32(q).reshape(b, sq, hkv, g, d)
    dof = _f32(dout).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, _f32(k))
    lse2 = _f32(lse).reshape(b, hkv, g, sq) * np.float32(LOG2E)
    p = torch.exp2((s.double() * scale2 - lse2.double()[..., None]).float())
    p = torch.where(p < 2.0 ** -126, 0.0, p)
    if causal:
        p = torch.where(torch.arange(sq)[:, None] >= torch.arange(sk)[None, :], p, 0.0)
    delta = (_f32(dout) * _f32(out)).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, _f32(v))
    dsr = _rounded(p * (dp - delta[..., None]), False)
    acc = None
    for k0 in range(0, sk, tile):
        part = torch.einsum("bhgqk,bkhd->bqhgd", dsr[..., k0:k0 + tile],
                            _f32(k)[:, k0:k0 + tile])
        acc = part if acc is None else acc + part
    return (acc * scale).reshape(b, sq, hq, d).to(q.dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_dq_model_meets_the_bf16_bar(shape):
    """The ordered sum of per-key-tile float32 partials (the wgmma body's
    dq) stays within half the bar of the plain version, as the whole-row
    sum of the model above does."""
    *dims, causal = shape
    inputs = _inputs(3 + sum(dims), *dims, causal)
    dq = tiled_dq_model(*inputs, causal=causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == inputs[0].shape
    ref = flash_attention_bwd_ref(*(_f32(x) for x in inputs[:5]), inputs[5], causal=causal)[0]
    share = float((_f32(dq) - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    assert share <= BAR / 2, share


def test_tiled_dq_model_is_the_whole_sum_up_to_order():
    """One key tile (every key in it) is the model above's dq exactly; more
    tiles only regroup the float32 sum."""
    inputs = _inputs(5, 1, 40, 4, 2, 64, True)
    whole = bwd_kernel_model(*inputs, causal=True, split_p=False, split_ds=False)[0]
    assert torch.equal(tiled_dq_model(*inputs, tile=64), whole)
    tiled = tiled_dq_model(*inputs, tile=16)
    assert float((_f32(tiled) - _f32(whole)).abs().max()) <= 2.0 ** -7 * float(_f32(whole).abs().max())
