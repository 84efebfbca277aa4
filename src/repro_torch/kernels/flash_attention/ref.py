"""Plain PyTorch version of the causal flash-attention kernel.

The same function as the CUDA kernel (``csrc/flash_attention.cu``) and as
the Pallas kernel it replaces (``repro/kernels/flash_attention``): GQA
attention with query and key positions counted from 0, scores, ``p`` and
``p·V`` in float32, output ``acc / max(l, 1e-20)`` in ``q``'s dtype.

The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.  On the
CPU autograd differentiates it (the training path there);
:func:`flash_attention_lse_ref` and :func:`flash_attention_bwd_ref` are the
plain versions of the forward's log-sum-exp output and of the backward
kernel (``csrc/flash_attention_bwd.cu``), the same formulas in float32.
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """Scaled float32 scores ``[B, Hkv, G, Sq, Sk]`` and the causal mask
    ``[Sq, Sk]`` (None when not causal)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(d))
    mask = None
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    return s, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True) -> torch.Tensor:
    """Each row's natural-log log-sum-exp of its scaled scores: ``[B, Hq,
    Sq]`` float32, what the forward kernel writes to ``lse``."""
    b, sq, hq, _ = q.shape
    s, mask = _scores(q, k, causal)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True):
    """``(dq, dk, dv)`` by the backward kernel's formulas in float32:
    ``p = exp(s - lse)``, ``D = Σ dout·out``, ``ds = p (dout·vᵀ - D)``,
    ``dv = pᵀ dout``, ``dk = scale dsᵀ q``, ``dq = scale ds k`` (summed over
    the query heads of each KV head), each in its input's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    s, mask = _scores(q, k, causal)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dof = dout.float().reshape(b, sq, hkv, g, d)
    delta = (dout.float() * out.float()).sum(-1)                     # [B, Sq, Hq]
    delta = delta.reshape(b, sq, hkv, g).permute(0, 2, 3, 1)         # [B, Hkv, G, Sq]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(b, sq, hkv, g, d)) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
