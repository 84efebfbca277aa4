"""zamba2-7b [arXiv:2411.15242].

81 Mamba-2 blocks (d_model=3584, state=64) with ONE shared transformer block
(32H MHA kv=32, head_dim 112, d_ff=14336) applied before every 6th block
(14 application sites, shared weights), as the reference simplifies the
Zamba2 pattern (residual application of the shared block).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
)
