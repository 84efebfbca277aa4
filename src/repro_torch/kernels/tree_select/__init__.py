from .ops import tree_select
from .ref import tree_select_ref

__all__ = ["tree_select", "tree_select_ref"]
