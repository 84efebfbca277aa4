# Training of the port: AdamW with float32 master weights, the microbatched
# train step, the data pipeline and checkpoints in the reference's format.
from .checkpoint import CheckpointManager
from .data import PackedShards, Prefetcher, SyntheticStream, write_token_shards
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_schedule
from .train_step import TrainConfig, make_train_step

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "TrainConfig",
    "make_train_step",
    "SyntheticStream",
    "PackedShards",
    "Prefetcher",
    "write_token_shards",
    "CheckpointManager",
]
