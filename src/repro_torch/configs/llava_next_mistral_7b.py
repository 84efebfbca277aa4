"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d=4096 32H (GQA kv=8) d_ff=14336 V=32000.  The
anyres vision tower + projector are stubbed: the caller supplies 576
precomputed (post-projector) patch embeddings (``batch["patch_embeds"]``),
prepended to the token stream.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_patches=576,
)
