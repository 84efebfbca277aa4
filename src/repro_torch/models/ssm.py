"""Mamba-2 (SSD, state-space duality) blocks of the port (counterpart of
``repro.models.ssm``): the chunked scan and the O(1) decode step.

The chunked formulation (Dao & Gu, arXiv:2405.21060) splits the sequence
into chunks of ``Q`` tokens: a quadratic intra-chunk term and a sequential
inter-chunk state pass.  :func:`ssm_block` runs the ``ssd_scan`` kernel on
a CUDA tensor and its plain version on a CPU tensor, whatever
``attn_impl`` says:

* cache-free (``forward``, and under grad ``loss_fn``): the reference
  kernel path's chunk rule (:func:`kernel_chunk`); differentiable on the
  card too, through ``ssd_scan``'s autograd function and the backward
  kernel ``ssd_scan_bwd``;
* ``return_cache`` (the prefill that starts a decode cache): the chunking
  of the reference's ``ssd_chunked``, ``Q = min(ssd_chunk, S)`` with ``S``
  padded to a multiple of ``Q`` by ``dt = 0`` tokens (exact), and the
  scan's final state (``ssd_scan(return_state=True)``);
* ``cache`` with one token: the O(1) recurrence, plain tensor ops, as the
  reference runs it (no kernel there either).

:func:`ssd_chunked` (the reference's padding scan) and
:func:`ssd_sequential_ref` (the O(S) recurrence) are the plain scans the
tests hold the kernel's plain version to.  The decode cache of a block is
``{"conv": [B, K-1, d_inner + 2N], "state": [B, H, P, N] float32}``
(:func:`init_ssm_cache`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .layers import local_inputs, normal, rms_norm

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
    # Zeros concatenated, not ``F.pad``: the same values and gradient, and
    # on placed tensors a backward that DTensor places right on torch 2.11
    # (``F.pad``'s comes back with one placement on a two-axis mesh).
    pad = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out


def _conv_step(window: torch.Tensor, x_t: torch.Tensor,
               w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One causal-conv step: ``window [B, K-1, C]`` holds the previous
    inputs, ``x_t [B, C]`` the new one, ``w [K, C]`` the taps.  Returns
    ``(out [B, C], window)``, computed in the promoted type of the window
    and the input (a float32 window promotes, as ``jnp.concatenate`` does)."""
    dtype = torch.promote_types(window.dtype, x_t.dtype)
    full = torch.cat([window.to(dtype), x_t[:, None, :].to(dtype)], dim=1)   # [B, K, C]
    out = torch.einsum("bkc,kc->bc", full, w.to(dtype))
    return out, full[:, 1:, :]


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
    # The reference's where(tri, exp(seg), 0) with the masked differences
    # set to -inf before the exp: the same values, and no 0 * inf (NaN) in
    # the gradient where the positive ones above the diagonal overflow.
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], -torch.inf))
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


def _scan_on_shards(fn, xdt, dA, bm, cm, **kw):
    """``fn(xdt, dA, bm, cm, **kw)`` for ``ssd_scan``: the call itself on
    plain tensors; on DTensors each rank's shards through ``local_map``,
    rows split as ``xdt``'s are over the data axes and heads as its heads
    are over ``model``, ``B``/``C`` whole over ``model``, so their
    gradients are each rank's part of the sum over heads.  With
    ``return_state`` the final state ``[B, H, P, N]`` splits as ``y``'s rows
    and heads."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xdt, DTensor):
        return fn(xdt, dA, bm, cm, **kw)
    mesh = xdt.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in xdt.placements)
    bc = tuple(p if p == Shard(0) else Replicate() for p in pl)
    bc_grad = tuple(Partial() if p == Shard(2) else q for p, q in zip(pl, bc))
    out_pl = list(pl)     # a list: one output
    if kw.get("return_state"):
        state = tuple(Shard(1) if p == Shard(2) else p for p in pl)
        out_pl = (pl, state)
    call = local_map(lambda *a: fn(*local_inputs(*a), **kw), out_placements=out_pl,
                     in_placements=(pl, pl, bc, bc),
                     in_grad_placements=(pl, pl, bc_grad, bc_grad),
                     device_mesh=mesh, redistribute_inputs=True)
    return call(xdt, dA, bm, cm)


def _scan_with_state(cfg, xdt, dA, bm, cm):
    """The cache-producing prefill's scan: ``ssd_chunked``'s chunking
    (``Q = min(ssd_chunk, S)``, ``S`` padded to a multiple of ``Q`` with
    ``dt = 0`` tokens: decay 1 and no state contribution, so the state is
    exact) through ``ssd_scan(return_state=True)``.  Returns ``(y [B, S, H,
    P], h_final [B, H, P, N])``."""
    s = xdt.shape[1]
    q = min(cfg.ssd_chunk, s)
    pad = -s % q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    y, h_final = _scan_on_shards(ssd_scan, xdt, dA, bm, cm, chunk=q, return_state=True)
    return y[:, :s], h_final


def ssm_block(p: dict, cfg, u: torch.Tensor, *, cache=None,
              return_cache: bool = False) -> tuple[torch.Tensor, Optional[dict]]:
    """Mamba-2 block.  ``u [B, S, d]`` -> ``(out [B, S, d], new_cache)``.

    ``cache`` (a block's decode cache) with ``S == 1`` takes the O(1)
    recurrence and returns the advanced cache.  Without a cache the scan
    goes through ``ssd_scan`` (the kernel on a CUDA tensor): cache-free
    with the chunk of :func:`kernel_chunk` (``new_cache`` is ``None``;
    differentiable, on the card through the backward kernel), or
    with ``return_cache`` with ``ssd_chunked``'s chunking and the final
    state, returning the cache a decode continues from.  ``xdt`` and
    ``dA`` are float32, ``B`` and ``C`` stay in the model's dtype."""
    b, s, _ = u.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    kk = cfg.conv_kernel

    x = u @ p["in_x"]
    z = u @ p["in_z"]
    bm = u @ p["in_B"]
    cm = u @ p["in_C"]
    dt = softplus((u @ p["in_dt"]).float() + p["dt_bias"])           # [B, S, H]
    a = -torch.exp(p["A_log"])                                        # [H]

    if cache is None or s > 1:
        if cache is not None:
            raise NotImplementedError("a chunked prefill continuing a decode cache "
                                      "(the reference has none either)")
        new_cache = None
        if return_cache:
            # The last K - 1 raw inputs, zero-padded on the left when the
            # prompt is shorter than that.
            raw = torch.cat([x, bm, cm], dim=-1)
            new_cache = {"conv": F.pad(raw, (0, 0, max(kk - 1 - s, 0), 0))[:, -(kk - 1):]}
        x = F.silu(_causal_conv(x, p["conv_x"]))
        bm = F.silu(_causal_conv(bm, p["conv_B"]))
        cm = F.silu(_causal_conv(cm, p["conv_C"]))
        xh = x.reshape(b, s, h, pdim)
        xdt = xh * dt[..., None]                                      # float32
        if return_cache:
            y, new_cache["state"] = _scan_with_state(cfg, xdt, dt * a, bm, cm)
        else:
            y = _scan_on_shards(ssd_scan, xdt, dt * a, bm, cm, chunk=kernel_chunk(cfg, s))
    else:
        # The O(1) decode step.
        packed = torch.cat([x[:, 0], bm[:, 0], cm[:, 0]], dim=-1)
        w_packed = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1)
        conv_out, conv_win = _conv_step(cache["conv"], packed, w_packed)
        conv_out = F.silu(conv_out)
        x_t = conv_out[:, :di].reshape(b, h, pdim).float()
        b_t = conv_out[:, di:di + n].float()
        c_t = conv_out[:, di + n:].float()
        dt_t = dt[:, 0]                                               # [B, H]
        da_t = torch.exp(dt_t * a)                                    # [B, H]
        hst = cache["state"] * da_t[:, :, None, None] + (
            (dt_t[:, :, None] * x_t)[..., None] * b_t[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", hst, c_t).reshape(b, 1, h, pdim)
        xh = x_t.reshape(b, 1, h, pdim)
        new_cache = {"conv": conv_win, "state": hst}
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(b, s, di)

    # Gated RMSNorm (Mamba-2), then the output projection.
    y = y.to(u.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.rms_eps)
    return y @ p["out"], new_cache


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> dict:
    """A zero decode cache of one block for ``batch`` rows: ``conv [batch,
    K-1, d_inner + 2N]`` in ``dtype`` and ``state [batch, H, P, N]`` in
    float32."""
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * n), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, h, pdim, n), dtype=torch.float32, device=device),
    }
