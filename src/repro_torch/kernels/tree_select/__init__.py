from .ops import tree_descend, tree_select
from .ref import tree_descend_ref, tree_select_ref

__all__ = ["tree_descend", "tree_descend_ref", "tree_select", "tree_select_ref"]
