"""Serving launcher of the port: the continuous-batching engine
(``repro_torch.serving.ServingEngine``) over any ported architecture, with
random parameters from a seed (counterpart of ``repro.launch.serve``).

On the GPU, full width and depth:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --requests 16 --slots 8 --prompt-len 96 --max-len 160

CPU-scale smoke (the reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --smoke \
      --requests 6 --prompt-len 12 --max-len 48 --device cpu

``--arch`` takes every name of ``repro_torch.configs.list_archs()``: the
dense and MoE families admit through the ragged batched prefill (KV
cache), mamba2-2.7b and zamba2-7b take the recurrent decode cache, and
llava-next-mistral-7b prefills one prompt at a time, text only.
whisper-small raises the reference's ``KeyError: 'frame_embeds'`` (its
prefill needs frame embeddings that a text prompt lacks).  ``--temperature`` above 0 samples each tick with
a key folded from seed 0 (the reference's launcher decodes greedily
whatever it is given).  ``--device`` defaults to ``cuda``; without a card
the launcher raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.api import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ServeConfig, ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> list[list[int]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    engine = ServingEngine(
        cfg, params,
        ServeConfig(batch_slots=args.slots, max_len=args.max_len,
                    temperature=args.temperature, eos_token=1),
        device=device)
    g = np.random.default_rng(0)
    prompts = [g.integers(2, cfg.vocab_size, size=args.prompt_len).tolist()
               for _ in range(args.requests)]
    key = rng.PRNGKey(0, device=device) if args.temperature > 0 else None
    t0 = time.perf_counter()
    outputs = engine.run(prompts, max_ticks=args.max_len * 2, key=key)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o) for o in outputs)
    for i, out in enumerate(outputs):
        print(f"request {i}: generated {len(out)} tokens: {out[:12]}...")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"\nserved {args.requests} requests on {args.slots} slots in {dt:.1f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s aggregate) on {where}")
    return outputs


if __name__ == "__main__":
    main()
