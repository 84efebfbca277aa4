"""Model configuration of the port (counterpart of ``repro.models.config``).

The dense, SSM (Mamba-2) and hybrid (Zamba2) families: the fields they
read, with a torch ``dtype``.  The other families' fields come with their
blocks.  ``attn_impl`` stays so configurations carry across, but it does
not choose the path: attention and the SSD scan on a CUDA tensor always
run the port's kernels, on a CPU tensor their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid (the ported families)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssd_chunk: int = 256

    # --- hybrid (Zamba2-style) ---
    attn_every: int = 0                   # shared attn block every k SSM blocks

    qkv_bias: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "xla"      # carried across; the device picks the path
    attn_chunk: int = 1024      # KV chunk of the plain chunked attention

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid only."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count of the ported families (as the
        reference counts it: without the final norm)."""
        d, L, V, hd = self.d_model, self.num_layers, self.vocab_size, self.head_dim
        total = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.family == "dense":
            return total + L * (attn + 3 * d * self.d_ff + 2 * d)
        if self.family not in ("ssm", "hybrid"):
            raise ValueError(f"family {self.family!r} is not ported")
        di, H, N = self.d_inner, self.ssm_heads, self.ssm_state
        blk = d * di * 2 + d * 2 * N + d * H + di * d \
            + self.conv_kernel * (di + 2 * N) + 3 * H + di
        total += L * (blk + d)
        if self.family == "hybrid":
            total += attn + 3 * d * self.d_ff + 2 * d     # the one shared block
        return total


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's sizes)."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype=torch.float32,
        attn_chunk=64,
    )
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=16)
    if cfg.family == "hybrid":
        base.update(attn_every=2)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
