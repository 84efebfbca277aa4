"""qwen2.5-32b [hf:Qwen/Qwen2.5 family]. 64L d=5120 40H (GQA kv=8) d_ff=27648 V=152064, QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
)
