from .ops import (
    decode_attention,
    decode_attention_split,
    decode_parts,
    paged_decode_attention,
    paged_decode_attention_split,
    paged_tree_decode_attention,
    tree_decode_attention,
)
from .ref import (
    decode_attention_ref,
    decode_attention_split_ref,
    paged_decode_attention_ref,
    paged_decode_attention_split_ref,
    paged_tree_decode_attention_ref,
    tree_decode_attention_ref,
)

__all__ = [
    "decode_attention",
    "decode_attention_ref",
    "decode_attention_split",
    "decode_attention_split_ref",
    "decode_parts",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "paged_decode_attention_split",
    "paged_decode_attention_split_ref",
    "paged_tree_decode_attention",
    "paged_tree_decode_attention_ref",
    "tree_decode_attention",
    "tree_decode_attention_ref",
]
