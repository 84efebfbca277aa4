"""Plain PyTorch version of the SSD scan kernel.

The same function as the CUDA kernel (``csrc/ssd_scan.cu``) and as the
Pallas kernel it replaces (``repro/kernels/ssd_scan/ssd_scan.py``,
``_ssd_kernel``): the Mamba-2 SSD scan cut into chunks of ``Q`` tokens,
walked in order with the ``[P, N]`` float32 state of each (batch, head)
carried from chunk to chunk.  Within a chunk, with ``cum`` the running sum
of ``dA`` from the chunk's start and ``total`` its last entry:

* ``y_i = Σ_{j <= i} (C_i · B_j) exp(cum_i - cum_j) xdt_j
  + exp(cum_i) C_i · hᵀ``;
* ``h <- exp(total) h + Σ_j exp(total - cum_j) xdt_jᵀ B_j``.

Here the chunk's terms are batched over (batch, head) as tensor products.
The decay is ``exp`` of the differences with those above the diagonal set
to ``-inf`` first: they are positive and overflow within a chunk (cum
falls by more than 88), and autograd of ``where(tri, exp(seg), 0)``, the
reference's form, then multiplies 0 by inf and gives a NaN gradient; the
values are the same.
The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.  On
the CPU autograd differentiates it (the training path there);
:func:`ssd_scan_bwd_ref` is the plain version of the backward kernel
(``csrc/ssd_scan_bwd.cu``), its gradient in closed form.
"""

from __future__ import annotations

import torch


def check_chunk(s: int, chunk: int) -> int:
    """The chunk length the scan uses, ``min(chunk, s)``; it must divide
    ``s`` (the Pallas kernel asserts the same)."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan: chunk {q} does not divide the sequence length {s}")
    return q


def _states(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, q: int, count: int) -> list:
    """The float32 states ``[B, H, P, N]`` entering chunks ``0 .. count - 1``
    (entry ``nc`` the one after the last chunk), from a zero state:
    ``h <- exp(total) h + Σ_j exp(total - cum_j) xdt_jᵀ B_j``."""
    b, _, h, p = x.shape
    states = [torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float32, device=x.device)]
    for c0 in range(0, (count - 1) * q, q):
        cum = torch.cumsum(a[:, c0:c0 + q], dim=1)                      # [B, Q, H]
        w_end = torch.exp(cum[:, -1:] - cum)
        states.append(states[-1] * torch.exp(cum[:, -1])[..., None, None]
                      + torch.einsum("bqhp,bqn->bhpn", x[:, c0:c0 + q] * w_end[..., None],
                                     bm[:, c0:c0 + q]))
    return states


def ssd_chunk_states_ref(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                         Cmat: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """The states entering each chunk, ``[B, nc, H, P, N]`` in float32
    (entry 0 is the zero initial state): what the kernel's state pass
    computes and what :func:`ssd_scan_bwd_ref` and the backward kernel take
    as ``states``.  The state entering chunk c is the final state of the
    scan over the first c·Q tokens.  ``Cmat`` is not read; it is taken so
    that the call reads as the scan's."""
    q = check_chunk(xdt.shape[1], chunk)
    return torch.stack(_states(xdt.float(), dA.float(), Bmat.float(), q, xdt.shape[1] // q), 1)


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                 Cmat: torch.Tensor, *, chunk: int = 256, return_state: bool = False):
    """``xdt [B, S, H, P]``, ``dA [B, S, H]``, ``Bmat``/``Cmat [B, S, N]``
    (shared by all heads) -> ``y [B, S, H, P]`` in float32, or with
    ``return_state`` ``(y, h_final [B, H, P, N])``: the state after the last
    chunk, as ``repro.models.ssm.ssd_chunked`` returns it.  The states come
    first, as in the kernel: the state entering each chunk, then each
    chunk's y."""
    s = xdt.shape[1]
    q = check_chunk(s, chunk)
    x, a = xdt.float(), dA.float()
    bm, cm = Bmat.float(), Cmat.float()
    states = _states(x, a, bm, q, s // q + 1 if return_state else s // q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    ys = []
    for c0, state in zip(range(0, s, q), states):
        xc, bc, cc = x[:, c0:c0 + q], bm[:, c0:c0 + q], cm[:, c0:c0 + q]
        cum = torch.cumsum(a[:, c0:c0 + q], dim=1)                      # [B, Q, H]
        cb = torch.einsum("bin,bjn->bij", cc, bc)                       # [B, Q, Q]
        seg = cum[:, :, None, :] - cum[:, None, :, :]                   # [B, Q, Q, H]
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None], -torch.inf))
        y = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay, xc)
        ys.append(y + torch.einsum("bin,bhpn->bihp", cc, state) * torch.exp(cum)[..., None])
    y = torch.cat(ys, dim=1)
    return (y, states[-1]) if return_state else y


def ssd_scan_bwd_ref(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                     Cmat: torch.Tensor, dy: torch.Tensor, *, chunk: int = 256,
                     states: torch.Tensor | None = None):
    """The gradient of :func:`ssd_scan_ref`'s ``y`` (no final state) for
    the output gradient ``dy [B, S, H, P]``: ``(dxdt, ddA, dB, dC)``,
    ``dxdt`` and ``ddA`` in float32, ``dB``/``dC`` in B's and C's dtype,
    in closed form, float32 inside.  Per (batch, head) and chunk, with
    ``L_ij = exp(cum_i - cum_j)`` (``j <= i``), ``G = C Bᵀ``, ``M = G ∘ L``,
    ``w_j = exp(total - cum_j)``, ``h`` the state entering the chunk and
    ``g`` the gradient of the state leaving it (zero after the last chunk):

    * ``g`` of the previous chunk ``= exp(total) g + Σ_i exp(cum_i) dy_i ⊗ C_i``
      (a reverse pass over the chunks);
    * ``dxdt_j = Σ_i M_ij dy_i + w_j g B_j``;
    * ``dM = dy xdtᵀ``, ``dG = dM ∘ L``: ``dC_i = Σ_j dG_ij B_j + exp(cum_i) hᵀ dy_i``,
      ``dB_j = Σ_i dG_ij C_i + w_j gᵀ xdt_j``, each summed over the heads (B
      and C are shared by them);
    * ``dcum_i = Σ_j (dM ∘ M)_ij - Σ_j (dM ∘ M)_ji + dy_i · exp(cum_i) h C_i
      - w_i xdt_i · g B_i``, and the last entry also takes ``d total =
      exp(total) <g, h> + Σ_j w_j xdt_j · g B_j``;
    * ``ddA`` is the reverse running sum of ``dcum`` within the chunk.

    ``states`` (``[B, nc, H, P, N]``, as :func:`ssd_chunk_states_ref` gives
    them) are taken as the states entering the chunks instead of being
    recomputed; entry 0 is not read."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    q = check_chunk(s, chunk)
    x, a, g = xdt.float(), dA.float(), dy.float()
    bm, cm = Bmat.float(), Cmat.float()
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    chunks = [slice(c0, c0 + q) for c0 in range(0, s, q)]
    # The state entering each chunk (the forward's state pass).
    if states is None:
        states = _states(x, a, bm, q, len(chunks))
    else:
        states = [torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)] + [
            states[:, c].float() for c in range(1, len(chunks))]
    dx, ddA = torch.empty_like(x), torch.empty_like(a)
    dB, dC = torch.empty_like(bm), torch.empty_like(cm)
    dh = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    for c, h_prev in zip(reversed(chunks), reversed(states)):
        xc, gc, bc, cc = x[:, c], g[:, c], bm[:, c], cm[:, c]
        cum = torch.cumsum(a[:, c], dim=1)                              # [B, Q, H]
        total = cum[:, -1]                                              # [B, H]
        e_cum = torch.exp(cum)
        w_end = torch.exp(total[:, None] - cum)
        seg = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
            ~tri[None, :, :, None], -torch.inf))                        # [B, i, j, H]
        mm = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * seg
        dm = torch.einsum("bihp,bjhp->bijh", gc, xc)
        dg = dm * seg
        pm = dm * mm
        g_b = torch.einsum("bhpn,bjn->bjhp", dh, bc)                   # g B_j
        h_c = torch.einsum("bhpn,bin->bihp", h_prev, cc)                # h C_i
        s_j = (xc * g_b).sum(-1)                                        # [B, Q, H]
        dx[:, c] = torch.einsum("bijh,bihp->bjhp", mm, gc) + w_end[..., None] * g_b
        dC[:, c] = (torch.einsum("bijh,bjn->bin", dg, bc)
                    + torch.einsum("bihp,bhpn->bin", gc * e_cum[..., None], h_prev))
        dB[:, c] = (torch.einsum("bijh,bin->bjn", dg, cc)
                    + torch.einsum("bjhp,bhpn->bjn", xc * w_end[..., None], dh))
        dcum = (pm.sum(2) - pm.sum(1) + (gc * h_c).sum(-1) * e_cum - w_end * s_j)
        d_total = torch.exp(total) * (dh * h_prev).sum((-1, -2)) + (w_end * s_j).sum(1)
        dcum[:, -1] += d_total
        ddA[:, c] = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])
        dh = (dh * torch.exp(total)[..., None, None]
              + torch.einsum("bqhp,bqn->bhpn", gc * e_cum[..., None], cc))
    return dx, ddA, dB.to(Bmat.dtype), dC.to(Cmat.dtype)
