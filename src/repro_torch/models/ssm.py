"""Mamba-2 (SSD, state-space duality) blocks of the port (counterpart of
``repro.models.ssm``): the cache-free path that ``forward`` runs.

The chunked formulation (Dao & Gu, arXiv:2405.21060) splits the sequence
into chunks of ``Q`` tokens: a quadratic intra-chunk term and a sequential
inter-chunk state pass.  :func:`ssm_block` runs the ``ssd_scan`` kernel on
a CUDA tensor and its plain version on a CPU tensor, with the reference
kernel path's chunk rule (:func:`kernel_chunk`), whatever ``attn_impl``
says.  :func:`ssd_chunked` (the reference's padding scan, which also
returns the final state) and :func:`ssd_sequential_ref` (the O(S)
recurrence) are the plain scans the tests hold the kernel's plain version
to.

The recurrent decode cache (``ssm_block(cache=...)``, ``return_cache``)
is not ported: it comes with serving (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .layers import normal, rms_norm

# Leaves of an SSM block that the reference keeps in float32 whatever the
# model's dtype (``repro/models/ssm.py`` ``init_ssm_block``).
FLOAT32_LEAVES = ("A_log", "dt_bias", "D")


def init_ssm_block(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    """Random parameters of the reference's shapes and dtypes (normal, std
    0.02; ``A_log``/``dt_bias`` zeros, ``D`` and ``norm`` ones)."""
    d, di, n, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    dev = gen.device
    std = 0.02
    return {
        "in_x": normal(gen, (d, di), std, dtype),
        "in_z": normal(gen, (d, di), std, dtype),
        "in_B": normal(gen, (d, n), std, dtype),
        "in_C": normal(gen, (d, n), std, dtype),
        "in_dt": normal(gen, (d, h), std, dtype),
        "conv_x": normal(gen, (k, di), std, dtype),
        "conv_B": normal(gen, (k, n), std, dtype),
        "conv_C": normal(gen, (k, n), std, dtype),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "out": normal(gen, (di, d), std, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S.  ``x [B, S, C]``, ``w [K, C]``;
    accumulated in ``x``'s dtype tap by tap from ``i = 0``, as the
    reference does."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` everywhere (torch's
    ``softplus`` returns ``x`` above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def kernel_chunk(cfg, s: int) -> int:
    """The reference kernel path's chunk: ``min(ssd_chunk, S)``, halved
    until it divides ``S``."""
    q = min(cfg.ssd_chunk, s)
    while s % q:
        q //= 2
    return q


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                Cmat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's plain path: ``xdt [B, S, H, P]``
    (x pre-multiplied by dt), ``dA [B, S, H]`` (dt * A, negative),
    ``Bmat``/``Cmat [B, S, N]``, optional initial state ``h0 [B, H, P, N]``
    -> ``(y [B, S, H, P], h_final [B, H, P, N])`` in float32.  A sequence
    that ``chunk`` does not divide is padded with ``dt = 0`` tokens (decay
    1, no state contribution), so the final state is exact."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    q = min(chunk, s)
    s_orig = s
    if s % q:
        pad = q - s % q
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
        s += pad
    nc = s // q
    xdt = xdt.float().reshape(b, nc, q, h, p)
    dA = dA.float().reshape(b, nc, q, h)
    bc = Bmat.float().reshape(b, nc, q, n)
    cc = Cmat.float().reshape(b, nc, q, n)

    cum = torch.cumsum(dA, dim=2)                                     # [B,nc,Q,H]
    total = cum[:, :, -1, :]                                          # [B,nc,H]

    # Intra-chunk quadratic term.
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                      # [B,nc,Q,Q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]               # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)

    # Inter-chunk state pass: each chunk's contribution decayed to its end.
    w_end = torch.exp(total[:, :, None, :] - cum)                     # [B,nc,Q,H]
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", w_end, bc, xdt)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
             if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                             # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, h_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y, state


def ssd_sequential_ref(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                       Cmat: torch.Tensor,
                       h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The O(S) sequential recurrence ``h_t = exp(dA_t) h_{t-1} + xdt_t ⊗
    B_t``, ``y_t = h_t · C_t`` (the oracle of the chunked scans) ->
    ``(y [B, S, H, P], h_final [B, H, P, N])`` in float32."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    x, a, bm, cm = xdt.float(), dA.float(), Bmat.float(), Cmat.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        state = state * torch.exp(a[:, t])[:, :, None, None] + (
            x[:, t, :, :, None] * bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1), state


def ssm_block(p: dict, cfg, u: torch.Tensor, *, cache=None,
              return_cache: bool = False) -> tuple[torch.Tensor, None]:
    """Mamba-2 block, cache-free.  ``u [B, S, d]`` -> ``(out [B, S, d],
    None)``.  The scan goes through ``ssd_scan`` (the kernel on a CUDA
    tensor) with the chunk of :func:`kernel_chunk`; ``xdt`` and ``dA`` are
    float32, ``B`` and ``C`` stay in the model's dtype."""
    if cache is not None or return_cache:
        raise NotImplementedError(
            "the recurrent SSM decode cache is not ported yet (ROADMAP.md §1: it "
            "comes with serving)")
    b, s, _ = u.shape
    di, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim

    x = u @ p["in_x"]
    z = u @ p["in_z"]
    bm = u @ p["in_B"]
    cm = u @ p["in_C"]
    dt = softplus((u @ p["in_dt"]).float() + p["dt_bias"])           # [B, S, H]
    a = -torch.exp(p["A_log"])                                        # [H]

    x = F.silu(_causal_conv(x, p["conv_x"]))
    bm = F.silu(_causal_conv(bm, p["conv_B"]))
    cm = F.silu(_causal_conv(cm, p["conv_C"]))
    xh = x.reshape(b, s, h, pdim)
    xdt = xh * dt[..., None]                                          # float32
    y = ssd_scan(xdt, dt * a, bm, cm, chunk=kernel_chunk(cfg, s))
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(b, s, di)

    # Gated RMSNorm (Mamba-2), then the output projection.
    y = y.to(u.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.rms_eps)
    return y @ p["out"], None
