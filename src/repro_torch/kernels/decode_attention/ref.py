"""Plain PyTorch version of the dense decode-attention kernel.

The same function as the CUDA kernel (``csrc/decode_attention.cu``) and as
the Pallas kernel it replaces (``repro/kernels/decode_attention``): one
query token per row attends the row's first ``kv_len`` cache entries, with
scores, ``p`` and ``p·V`` in float32 and the output ``acc / max(l, 1e-20)``,
so a row with ``kv_len = 0`` gives zeros.  (The XLA oracle in
``models/layers.py::decode_attention`` rounds ``p`` to the cache's type
first, and gives a ``kv_len = 0`` row the mean of V.)

The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """``q [B, Hq, D]``, caches ``[B, S, Hkv, D]``, ``kv_len`` int ``[]``
    or ``[B]`` -> ``[B, Hq, D]`` in ``q``'s dtype."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, group, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = (pos[None, :] < lens)[:, None, None, :]          # [B or 1, 1, 1, S]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = out / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)
