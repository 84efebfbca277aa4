"""phi3-medium-14b [arXiv:2404.14219]. 40L d=5120 40H (GQA kv=10) d_ff=17920 V=100352."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
)
