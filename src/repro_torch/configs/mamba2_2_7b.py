"""mamba2-2.7b [arXiv:2405.21060]. 64L d=2560 (attention-free), state=128, V=50280."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)
