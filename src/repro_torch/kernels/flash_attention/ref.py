"""Plain PyTorch version of the causal flash-attention kernel.

The same function as the CUDA kernel (``csrc/flash_attention.cu``) and as
the Pallas kernel it replaces (``repro/kernels/flash_attention``): GQA
attention with query and key positions counted from 0, scores, ``p`` and
``p·V`` in float32, output ``acc / max(l, 1e-20)`` in ``q``'s dtype.

The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """``q [B, Sq, Hq, D]``, ``k``/``v [B, Sk, Hkv, D]`` -> ``[B, Sq, Hq, D]``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp_min(l, 1e-20)[..., None]
    return o.reshape(b, hq, sq, d).transpose(1, 2).to(q.dtype)
