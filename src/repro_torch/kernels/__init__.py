"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "tree_select": 0,
    "tree_descend": 0,
    "decode_attention": 0,
    "flash_attention": 0,
    "paged_decode_attention": 0,
    "tree_decode_attention": 0,
    "paged_tree_decode_attention": 0,
    "ssd_scan": 0,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
