"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) vocab=151936; MoE: 128 routed experts top-8,
per-expert d_ff=1536.  No shared experts.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
)
