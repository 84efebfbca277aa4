"""deepseek-67b [arXiv:2401.02954]. 95L d=8192 64H (GQA kv=8) d_ff=22016 V=102400."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
)
