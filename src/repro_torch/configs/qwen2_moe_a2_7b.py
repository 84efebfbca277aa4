"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) vocab=151936; MoE: 60 routed experts top-4
(per-expert d_ff=1408) + 4 shared experts (fused as one 4x1408=5632 SwiGLU).
On one device the 60 experts run unpadded; ``num_experts_real`` masks the
router logits of padding experts where a layout pads them.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    shared_expert_d_ff=5632,
    qkv_bias=True,
)
