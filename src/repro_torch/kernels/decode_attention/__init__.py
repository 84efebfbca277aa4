from .ops import (
    decode_attention,
    paged_decode_attention,
    paged_tree_decode_attention,
    tree_decode_attention,
)
from .ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_tree_decode_attention_ref,
    tree_decode_attention_ref,
)

__all__ = [
    "decode_attention",
    "decode_attention_ref",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "paged_tree_decode_attention",
    "paged_tree_decode_attention_ref",
    "tree_decode_attention",
    "tree_decode_attention_ref",
]
