"""Model configuration of the port (counterpart of ``repro.models.config``).

The dense family only: the fields it reads, with a torch ``dtype``.  The
other families' fields come with their blocks.  ``attn_impl`` stays so
configurations carry across, but it does not choose the path: attention on
a CUDA tensor always runs the port's kernels, on a CPU tensor their plain
versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the port's only family so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
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

    def param_count(self) -> int:
        """Approximate parameter count of the dense family (as the
        reference counts it: without the final norm)."""
        d, L, V, hd = self.d_model, self.num_layers, self.vocab_size, self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        ffn = 3 * d * self.d_ff
        return V * d * (1 if self.tie_embeddings else 2) + L * (attn + ffn + 2 * d)


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
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
