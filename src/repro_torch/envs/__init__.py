from .bandit_tree import make_bandit_tree, solve_bandit_tree
from .base import Environment
from .tap_game import make_tap_game

__all__ = [
    "Environment",
    "make_bandit_tree",
    "make_tap_game",
    "solve_bandit_tree",
]
