"""whisper-small [arXiv:2212.04356].

Enc-dec: 12 encoder + 12 decoder layers, d=768 12H (MHA) d_ff=3072 V=51865.
The conv frontend is stubbed: the caller supplies 1500 precomputed frame
embeddings (``batch["frame_embeds"]``).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    num_encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    encoder_seq=1500,
)
