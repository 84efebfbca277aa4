"""End to end: serve a small LM with batched requests and run WU-UCT token
search against it — the paper's technique on the serving stack, with an LM
as both the environment and the rollout policy (the port's counterpart of
``examples/serve_search.py``).

1. build a reduced policy LM (any ``--arch`` of the KV-cache families);
2. train it briefly on a synthetic Zipf stream so it has structure;
3. serve a batch of requests through the continuous-batching engine;
4. run WU-UCT over the token environment (``SearchSpec`` +
   ``build_searcher``) and compare the searched continuation's reward with
   greedy decoding's;
5. serve a batch of search requests through ``SearchService``: B trees in
   one program, all rollout slots evaluated by one model forward a tick.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_search [--arch llama3-8b] \
          [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import get_reduced
from repro_torch.core import SearchSpec, build_searcher
from repro_torch.core.api import resolve_device
from repro_torch.envs.base import map_state
from repro_torch.envs.token_env import make_token_env
from repro_torch.models import init_params
from repro_torch.serving import SearchService, ServeConfig, ServingEngine
from repro_torch.training import (
    AdamWConfig,
    SyntheticStream,
    TrainConfig,
    adamw_init,
    make_train_step,
)
from repro_torch.training.data import to_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--simulations", type=int, default=32,
                    help="simulations of the token search (the service runs half)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(get_reduced(args.arch), vocab_size=args.vocab)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))

    # --- 1. quick policy training on synthetic data -----------------------
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5,
                                           total_steps=args.train_steps))
    step = make_train_step(cfg, tc)
    opt = adamw_init(params)
    stream = SyntheticStream(cfg.vocab_size, batch_size=8, seq_len=48, seed=0)
    losses = []
    for s in range(args.train_steps):
        params, opt, m = step(params, opt, to_device(stream.batch_at(s), device))
        losses.append(m["loss"])
        if (s + 1) % 10 == 0:
            print(f"train step {s + 1}: loss={m['loss']:.3f}")

    # --- 2. batched serving ----------------------------------------------
    engine = ServingEngine(cfg, params, ServeConfig(batch_slots=4, max_len=48, eos_token=1),
                           device=device)
    g = np.random.default_rng(0)
    prompts = [g.integers(2, cfg.vocab_size, size=8).tolist() for _ in range(6)]
    t0 = time.perf_counter()
    outputs = engine.run(prompts, max_ticks=64)
    n_tok = sum(len(o) for o in outputs)
    print(f"\nserved {len(prompts)} requests -> {n_tok} tokens "
          f"({n_tok / (time.perf_counter() - t0):.1f} tok/s on {device.type})")

    # --- 3. WU-UCT token search vs greedy decoding ------------------------
    env = make_token_env(cfg, params, torch.tensor(prompts[0], dtype=torch.int32),
                         max_len=20, top_k=6, eos_token=1)
    spec = SearchSpec(algo="wu_uct", num_simulations=args.simulations, wave_size=8,
                      max_depth=10, max_sim_steps=10, max_width=6, gamma=1.0)
    search = build_searcher(env, spec, device=device)
    state = env.init(rng.PRNGKey(0, device=device)[None])        # a batch of one
    # Greedy continuation's reward (action 0 = the top-1 token at each step).
    g_state, g_reward = state, 0.0
    for _ in range(6):
        g_state, r, d = env.step(g_state, torch.zeros(1, dtype=torch.int32, device=device))
        g_reward += float(r[0])
        if bool(d[0]):
            break
    s_state, s_reward = state, 0.0
    key = rng.PRNGKey(1, device=device)
    for _ in range(6):
        key, k = rng.split(key)
        res = search(map_state(lambda x: x[0], s_state), k)
        s_state, r, d = env.step(s_state, res.action.reshape(1).to(device))
        s_reward += float(r[0])
        if bool(d[0]):
            break
    print(f"token search: greedy logp={g_reward:.3f}  WU-UCT logp={s_reward:.3f}  "
          f"(search >= greedy expected)")

    # --- 4. batched search serving (one model forward per master tick) ----
    service = SearchService(
        cfg, params,
        SearchSpec(algo="wu_uct", engine="async", batch=4,
                   num_simulations=max(args.simulations // 2, 4), wave_size=4, max_depth=8,
                   max_sim_steps=8, max_width=6, gamma=1.0),
        top_k=6, max_len=20, eos_token=1, device=device)
    t0 = time.perf_counter()
    tokens, _ = service.decide(prompts[:4], rng.PRNGKey(2, device=device))
    print(f"search service: {len(tokens)} searched next-tokens {list(tokens)} in "
          f"{time.perf_counter() - t0:.1f}s (B=4 trees, one LM forward per tick)")
    return {"losses": losses, "outputs": outputs, "greedy_reward": g_reward,
            "search_reward": s_reward, "service_tokens": list(tokens)}


if __name__ == "__main__":
    main()
