"""Model configuration of the port (counterpart of ``repro.models.config``).

One dataclass covers every family — dense, MoE, SSM (Mamba-2), hybrid
(Zamba2), the VLM stub and enc-dec (Whisper) — with a torch ``dtype``.
The reference's training fields are carried: ``remat`` (each layer's body
recomputed in the backward, ``torch.utils.checkpoint``) and ``loss_chunk``
(the LM head and cross entropy chunked over the sequence), and so is
``seq_shard_activations`` (the residual stream split over the sequence
and ``model`` at block boundaries under a mesh).  Its dry-run field
``scan_layers`` is not: the port's layer loop is always unrolled.
``attn_impl`` stays so configurations carry across, but it does not choose
the path: attention and the SSD scan on a CUDA tensor always run the
port's kernels, on a CPU tensor their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads

    # --- MoE ---
    num_experts: int = 0                  # routed experts
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                     # per-expert hidden size
    shared_expert_d_ff: int = 0           # fused shared-experts hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Experts >= num_experts_real are dead (router logits masked to -1e30).
    num_experts_real: Optional[int] = None

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssd_chunk: int = 256

    # --- hybrid (Zamba2-style) ---
    attn_every: int = 0                   # shared attn block every k SSM blocks

    # --- VLM stub ---
    num_patches: int = 0                  # precomputed patch embeds prepended

    # --- enc-dec (Whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 0                  # precomputed frame embeds (stub)

    qkv_bias: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "xla"      # carried across; the device picks the path
    attn_chunk: int = 1024      # KV chunk of the plain chunked attention
    remat: bool = True          # recompute each layer's body in the backward
    # Chunked cross entropy: peak logits B*loss_chunk*V instead of B*S*V.
    # 0 = unchunked.
    loss_chunk: int = 0
    # Megatron-style sequence parallelism: the residual stream split over
    # (batch over the data axes, seq over model) at block boundaries.  No-op
    # outside a mesh or where seq does not divide.
    seq_shard_activations: bool = False

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

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d

    def _moe_params(self, experts: int) -> int:
        d = self.d_model
        return 3 * d * self.moe_d_ff * experts + 3 * d * self.shared_expert_d_ff \
            + d * self.num_experts

    def param_count(self) -> int:
        """Approximate parameter count, as the reference counts it (without
        the final norm)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        if self.family in ("dense", "vlm"):
            return total + L * (attn + 3 * d * self.d_ff + 2 * d)
        if self.family == "moe":
            return total + L * (attn + self._moe_params(self.num_experts) + 2 * d)
        if self.family == "encdec":
            ffn = 3 * d * self.d_ff
            total += self.num_encoder_layers * (attn + ffn + 2 * d)
            return total + L * (2 * attn + ffn + 3 * d)    # self + cross attention
        if self.family not in ("ssm", "hybrid"):
            raise ValueError(f"unknown family {self.family!r}")
        di, H, N = self.d_inner, self.ssm_heads, self.ssm_state
        blk = d * di * 2 + d * 2 * N + d * H + di * d \
            + self.conv_kernel * (di + 2 * N) + 3 * H + di
        total += L * (blk + d)
        if self.family == "hybrid":
            total += attn + 3 * d * self.d_ff + 2 * d     # the one shared block
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: the routed top-k and the shared
        experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n_embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n_embed + L * (self._attn_params()
                              + self._moe_params(self.num_experts_per_tok) + 2 * d)


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
        remat=False,
    )
    if cfg.family == "moe":
        base.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
                    shared_expert_d_ff=64 if cfg.shared_expert_d_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=16)
    if cfg.family == "hybrid":
        base.update(attn_every=2)
    if cfg.family == "vlm":
        base.update(num_patches=8)
    if cfg.family == "encdec":
        base.update(num_encoder_layers=2, encoder_seq=16)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
