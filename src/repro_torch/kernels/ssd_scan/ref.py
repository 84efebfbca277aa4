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
The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.
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


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor,
                 Cmat: torch.Tensor, *, chunk: int = 256, return_state: bool = False):
    """``xdt [B, S, H, P]``, ``dA [B, S, H]``, ``Bmat``/``Cmat [B, S, N]``
    (shared by all heads) -> ``y [B, S, H, P]`` in float32, or with
    ``return_state`` ``(y, h_final [B, H, P, N])``: the state after the last
    chunk, as ``repro.models.ssm.ssd_chunked`` returns it."""
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    q = check_chunk(s, chunk)
    x, a = xdt.float(), dA.float()
    bm, cm = Bmat.float(), Cmat.float()
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    ys = []
    for c0 in range(0, s, q):
        xc, bc, cc = x[:, c0:c0 + q], bm[:, c0:c0 + q], cm[:, c0:c0 + q]
        cum = torch.cumsum(a[:, c0:c0 + q], dim=1)                      # [B, Q, H]
        total = cum[:, -1]                                              # [B, H]
        cb = torch.einsum("bin,bjn->bij", cc, bc)                       # [B, Q, Q]
        seg = cum[:, :, None, :] - cum[:, None, :, :]                   # [B, Q, Q, H]
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        y = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay, xc)
        y = y + torch.einsum("bin,bhpn->bihp", cc, state) * torch.exp(cum)[..., None]
        ys.append(y)
        w_end = torch.exp(total[:, None, :] - cum)                      # [B, Q, H]
        s_chunk = torch.einsum("bqhp,bqn->bhpn", xc * w_end[..., None], bc)
        state = state * torch.exp(total)[..., None, None] + s_chunk
    y = torch.cat(ys, dim=1)
    return (y, state) if return_state else y
