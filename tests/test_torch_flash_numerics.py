"""What the bf16 flash-attention kernel computes, modelled on the CPU.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores: the
scores are float32 sums of exact bf16 products, the online softmax runs in
float32 over key tiles in log2 units (``exp2``; the tile is read from the
source: ``kKeyTile`` keys in the wgmma body at D >= 64, ``kMmaBlockK`` in
the mma.sync body at D = 16 and 32), and P.V is two bf16
products, one of ``hi = bf16(p)`` and one of ``lo = bf16(p - hi)``,
accumulated in float32; the output is rounded to bf16 once.  This file
models that arithmetic in plain PyTorch and holds it against the plain
version ``flash_attention_ref`` within the bf16 bar that ``chip_smoke.py``
holds the kernel to (``ATTN_TOL["bfloat16"]``: ``|out - ref| <= 1e-5 +
2^-7 |ref|``).  It also pins that rounding ``p`` once to bf16 (as fused
attention libraries do) breaks that bar, which is why the kernel splits
``p``.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
NEG_INF = -1e30


def _key_tiles():
    """Keys per tile of the online softmax, as the kernel's source sets
    them: the wgmma body's (D >= 64) and the mma.sync body's (D < 64)."""
    text = SOURCE.read_text()
    found = {name: re.search(rf"constexpr int {name} = (\d+);", text)
             for name in ("kKeyTile", "kMmaBlockK")}
    assert all(found.values()), "the kernel no longer states its key tiles"
    return int(found["kKeyTile"].group(1)), int(found["kMmaBlockK"].group(1))


WGMMA_KEYS, MMA_KEYS = _key_tiles()


def block_k(d):
    """The key tile of the bf16 body that runs at head dim ``d``."""
    return WGMMA_KEYS if d >= 64 else MMA_KEYS


def _attn_tol():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.ATTN_TOL["bfloat16"]


ATOL, RTOL = _attn_tol()


def _bf16_inputs(seed, b, s, hq, hkv, d):
    rs = np.random.default_rng(seed)
    return [torch.from_numpy(rs.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def kernel_model(q, k, v, *, causal=True, split_p=True, tile=None):
    """The bf16 kernel's arithmetic: float32 scores, a float32 online
    softmax over key tiles (the kernel's at this head dim, or ``tile``) in
    log2 units, P.V from ``hi + lo`` (``split_p``) or from ``bf16(p)``
    alone, float32 accumulation, one rounding of the output."""
    b, sq, hq, d = q.shape
    tile = block_k(d) if tile is None else tile
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * (math.log2(math.e) / math.sqrt(d))
    if causal:
        mask = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(mask, s, NEG_INF)
    m = torch.full(s.shape[:-1], NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], d)
    for k0 in range(0, sk, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        if causal:
            p = torch.where(mask[:, k0:k0 + tile], p, 0.0)
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, k0:k0 + tile]
        pv = torch.einsum("bhgqk,bkhd->bhgqd", hi, vt)
        if split_p:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhgqk,bkhd->bhgqd", lo, vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, hq, sq, d).transpose(1, 2).to(q.dtype)


def _outside(out, ref):
    """Elements outside the bf16 bar, and the largest |out - ref|."""
    diff = (out.float() - ref.float()).abs()
    return int((diff > ATOL + RTOL * ref.float().abs()).sum()), float(diff.max())


def test_bar_is_chip_smokes():
    assert (ATOL, RTOL) == (1e-5, 2.0 ** -7)


def test_key_tiles_are_whole_k16_steps():
    """Each tile is a whole number of the products' 16-key steps."""
    assert WGMMA_KEYS in (32, 64) and MMA_KEYS == 32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 112])
@pytest.mark.parametrize("s", [7, 160])
def test_split_p_model_meets_the_bf16_bar(s, d, causal):
    q, k, v = _bf16_inputs(100 * s + d, 2, s, 4, 2, d)
    out = kernel_model(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    bad, worst = _outside(out, ref)
    assert bad == 0, f"{bad} of {out.numel()} outputs outside the bar (max |err| {worst})"


@pytest.mark.parametrize("d", [64, 128])
def test_one_bf16_rounding_of_p_breaks_the_bar(d):
    """At the main path's length, bf16(p) alone misses the bar on many
    outputs while the split meets it on the same inputs."""
    q, k, v = _bf16_inputs(7 + d, 2, 160, 8, 8, d)
    ref = flash_attention_ref(q, k, v)
    bad_single, _ = _outside(kernel_model(q, k, v, split_p=False), ref)
    bad_split, _ = _outside(kernel_model(q, k, v), ref)
    assert bad_split == 0
    assert bad_single > ref.numel() // 100, (bad_single, ref.numel())


@pytest.mark.parametrize("tile", [32, 64])
def test_split_p_model_meets_the_bf16_bar_at_either_tile(tile):
    """The sweep's 32- and 64-key tiles both keep the split's bar (the
    tile only regroups the online softmax's rescaling)."""
    q, k, v = _bf16_inputs(11 + tile, 2, 160, 8, 2, 128)
    bad, worst = _outside(kernel_model(q, k, v, tile=tile), flash_attention_ref(q, k, v))
    assert bad == 0, f"{bad} outputs outside the bar at {tile}-key tiles (max |err| {worst})"
