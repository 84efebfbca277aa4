from .bandit_tree import make_bandit_tree, solve_bandit_tree
from .base import Environment
from .random_mdp import RandomMDPState, make_random_mdp
from .tap_game import make_tap_game
from .token_env import TokenEnvState, make_token_env

__all__ = [
    "Environment",
    "RandomMDPState",
    "TokenEnvState",
    "make_bandit_tree",
    "make_random_mdp",
    "make_tap_game",
    "make_token_env",
    "solve_bandit_tree",
]
