"""The one front door for search: ``SearchSpec`` -> ``build_searcher``
(counterpart of ``repro.core.api``).

:class:`SearchSpec` has the reference's fields; :func:`build_searcher`
returns a plain callable (PyTorch runs eagerly: there is no ``jit``) that
runs on CUDA unless the caller asks for another device.

Every algo of the reference runs: ``wu_uct``, ``uct``, ``treep`` and
``treep_vc`` on the wave and the async engine, single-root (``batch=0``)
and batched (``batch=B``); the baselines ``leafp`` and ``rootp``
(:mod:`repro_torch.core.baselines`) single-root on the wave engine, as in
the reference.  Leaves are evaluated by environment rollouts
(:class:`RolloutEvaluator`, the default), an LM forward per tick
(:class:`ModelEvaluator`) or a KV-cached decode step per tick
(:class:`CachedModelEvaluator` and its paged and frontier subclasses,
async engine only).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..envs.base import Environment, map_state
from .async_search import run_async_search
from .baselines import run_leafp, run_rootp
from .batched_async_search import run_async_search_batched
from .batched_search import run_search_batched
from .evaluators import CachedModelEvaluator, Evaluator, ModelEvaluator
from .policies import PolicyConfig
from .wu_uct import SearchConfig, SearchResult, run_search

State = Any

ALGOS = ("wu_uct", "uct", "treep", "treep_vc", "leafp", "rootp")
ENGINES = ("wave", "async")


class SearchSpec(NamedTuple):
    """Frozen description of one search program (the reference's fields)."""

    algo: str = "wu_uct"            # wu_uct | uct | treep | treep_vc | leafp | rootp
    engine: str = "wave"            # wave | async
    batch: int = 0                  # B > 0: multi-root lockstep engine
    num_simulations: int = 128      # T_max
    wave_size: int = 16             # W — in-flight workers
    max_depth: int = 100            # d_max
    max_sim_steps: int = 100        # simulation rollout cap (App. D: 100)
    max_width: int = 20             # search-width cap (paper: 5 tap / 20 Atari)
    gamma: float = 0.99
    beta: float = 1.0               # exploration constant β
    r_vl: float = 1.0               # TreeP virtual loss
    n_vl: float = 1.0               # TreeP-VC virtual pseudo-count (eq. 7)
    expand_coin: float = 0.5        # traversal rule (iii) stop probability
    value_mix: float = 0.0          # R = (1-m)·R_simu + m·V(s)  (App. D: 0.5)
    deterministic_expansion: bool = False  # first-untried action (tests)
    use_kernel: bool = True         # False only on the CPU, which runs the plain version

    @property
    def config(self) -> SearchConfig:
        return as_search_config(self)


# Per-algo (policy kind, stat_mode), as in the reference.
_ALGO_MODES = {
    "wu_uct": ("wu_uct", "wu"),
    "uct": ("uct", "none"),
    "treep": ("treep", "vl"),
    "treep_vc": ("treep_vc", "wu"),
    "leafp": ("uct", "none"),
    "rootp": ("uct", "none"),
}


def as_search_config(spec: SearchSpec) -> SearchConfig:
    """Lower a :class:`SearchSpec` to the engine's :class:`SearchConfig`."""
    if spec.algo not in ALGOS:
        raise ValueError(f"unknown algo {spec.algo!r}; expected one of {ALGOS}")
    if spec.engine not in ENGINES:
        raise ValueError(f"unknown engine {spec.engine!r}; expected one of {ENGINES}")
    kind, stat_mode = _ALGO_MODES[spec.algo]
    return SearchConfig(
        num_simulations=spec.num_simulations,
        # Sequential UCT is the W=1 special case by definition (eq. 2).
        wave_size=1 if spec.algo == "uct" else spec.wave_size,
        max_depth=spec.max_depth,
        max_sim_steps=spec.max_sim_steps,
        max_width=spec.max_width,
        gamma=spec.gamma,
        policy=PolicyConfig(kind=kind, beta=spec.beta, r_vl=spec.r_vl, n_vl=spec.n_vl),
        stat_mode=stat_mode,
        expand_coin=spec.expand_coin,
        value_mix=spec.value_mix,
        deterministic_expansion=spec.deterministic_expansion,
    )


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    return dev


def build_searcher(env: Environment, spec: SearchSpec, *,
                   evaluator: Optional[Evaluator] = None, device=None,
                   constrain: Optional[Callable[[Any], Any]] = None):
    """Build the searcher described by ``spec`` for ``env``.

    Returns a plain callable that moves its inputs to ``device`` (default
    ``"cuda"``) and runs there:

    * ``batch == 0`` — ``search(root_state, rng) -> SearchResult`` with key
      data ``rng[2]``;
    * ``batch  > 0`` — ``search(root_states, rngs) -> SearchResult`` with a
      leading ``[B]`` axis on every field (``rngs`` is ``[B, 2]``).

    ``leafp`` and ``rootp`` take the wave engine with ``batch == 0`` only
    (``ValueError`` otherwise, as in the reference).

    ``evaluator`` plugs the leaf evaluation (default: environment
    rollouts); :class:`CachedModelEvaluator` and its paged and frontier
    subclasses need ``engine='async'``, and a model evaluator's ``top_k``
    must equal ``env.num_actions``.

    Selection on a GPU always runs the ``tree_descend`` kernel (one launch
    walks every tree), and on the CPU always its plain version, so
    ``spec.use_kernel=False`` is accepted only with a CPU device.

    ``constrain`` is phase 2's hook on the slot batch and its results
    (:func:`repro_torch.distributed.sharding.constrain_search_batch` splits
    the slots over the data axes of the ambient mesh, and is a no-op
    outside one); the single-root async engine and the baselines
    ``leafp``/``rootp`` take none, as in the reference.  With a model
    evaluator on the batched async engine the hook splits the evaluator's
    slot aux too: each data rank prefills, decodes and refills its own
    trees against its own caches (a paged pool of ``num_blocks // ranks``
    blocks), so the data ranks must divide ``batch`` (and ``num_blocks``).
    """
    cfg = as_search_config(spec)
    if spec.batch < 0:
        raise ValueError(f"batch must be >= 0, got {spec.batch}")
    name = type(evaluator).__name__
    if evaluator is not None and not isinstance(evaluator, Evaluator):
        raise TypeError(f"evaluator must be a repro_torch Evaluator, got {name}")
    if isinstance(evaluator, ModelEvaluator) and evaluator.top_k != env.num_actions:
        # Actions are ranks into the evaluator's top-K table; a mismatched
        # table would silently alias several env actions onto one token.
        raise ValueError(f"ModelEvaluator(top_k={evaluator.top_k}) does not match "
                         f"env.num_actions={env.num_actions}")
    if isinstance(evaluator, CachedModelEvaluator) and spec.engine != "async":
        # The KV slot cache lives in the async engine's slot aux; the wave
        # engine evaluates whole rollouts per slot without it.
        raise ValueError("CachedModelEvaluator requires engine='async' (the wave "
                         "engine carries no slot cache; use ModelEvaluator)")
    if spec.algo in ("leafp", "rootp"):
        if spec.engine == "async":
            raise ValueError(f"engine='async' supports wave-engine algos, not {spec.algo!r}")
        if spec.batch > 0:
            raise ValueError(f"batch > 0 supports wave-engine algos, not {spec.algo!r} "
                             "(rootp is itself a K-tree batched committee)")
    on_gpu = torch.device("cuda" if device is None else device).type == "cuda"
    if not spec.use_kernel and on_gpu:
        raise ValueError("use_kernel=False would bypass the tree_descend kernel on "
                         "the GPU; the plain version runs only on the CPU")
    dev = resolve_device(device)
    if spec.engine == "async":
        run = run_async_search_batched if spec.batch > 0 else run_async_search
    elif spec.batch > 0:
        run = run_search_batched
    else:
        run = {"leafp": run_leafp, "rootp": run_rootp}.get(spec.algo, run_search)
    takes = spec.batch > 0 or (spec.engine != "async" and spec.algo not in ("leafp", "rootp"))
    hook = {"constrain": constrain} if constrain is not None and takes else {}
    fn = functools.partial(run, env, cfg, evaluator=evaluator, **hook)

    def search(root_states: State, rngs: torch.Tensor) -> SearchResult:
        return fn(map_state(lambda x: torch.as_tensor(x, device=dev), root_states),
                  torch.as_tensor(rngs, device=dev))

    return search


def make_config(algorithm: str, **kw) -> SearchConfig:
    """Config builder over :class:`SearchSpec`, as the reference's.

    ``kw`` takes the flattened spec fields (``beta=...``, ``r_vl=...``,
    search budgets); explicit ``policy=`` / ``stat_mode=`` overrides win.
    """
    policy = kw.pop("policy", None)
    stat_mode = kw.pop("stat_mode", None)
    cfg = as_search_config(SearchSpec(algo=algorithm, **kw))
    if policy is not None:
        cfg = cfg._replace(policy=policy)
    if stat_mode is not None:
        cfg = cfg._replace(stat_mode=stat_mode)
    return cfg
