"""The paper's own experiment configurations (Sec. 5 / App. D; counterpart
of ``repro.configs.wu_uct_paper``).

Atari: 128 simulations, 16 simulation workers, search width 20, depth 100,
gamma 0.99, 100-step rollouts with value bootstrap mixing 0.5.
Tap game: width 5, depth 10, 100 simulations, 20-step rollouts.
"""

from ..core.policies import PolicyConfig
from ..core.wu_uct import SearchConfig

ATARI = SearchConfig(
    num_simulations=128,
    wave_size=16,
    max_depth=100,
    max_sim_steps=100,
    max_width=20,
    gamma=0.99,
    policy=PolicyConfig(kind="wu_uct", beta=1.0),
    stat_mode="wu",
    value_mix=0.5,
)

TAP_GAME = SearchConfig(
    num_simulations=100,
    wave_size=16,
    max_depth=10,
    max_sim_steps=20,
    max_width=5,
    gamma=1.0,
    policy=PolicyConfig(kind="wu_uct", beta=1.0),
    stat_mode="wu",
)
