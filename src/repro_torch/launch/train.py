"""Training launcher of the port: data pipeline, train loop, checkpoints
(counterpart of ``repro.launch.train``).

* deterministic data addressing (resuming restores only the step counter);
* atomic, asynchronous checkpoints with keep-k;
* optional int8 error-feedback gradient compression.

CPU-scale smoke (the reduced config, chunked loss as the reference's smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \
      --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

On the GPU (``--device`` defaults to ``cuda``; without a card the launcher
raises unless ``--device cpu`` is given) any ported architecture trains at
its published width; the loop is :func:`train`, which ``chip_smoke.py``
calls with llama3-8b cut to 8 layers (the full model's AdamW state does
not fit one card), mamba2-2.7b at full depth and zamba2-7b cut to 24 of
its 81 blocks: at full depth zamba2-7b, like llama3-8b, needs more than
one card for its AdamW state.  The SSM scan trains through ``ssd_scan``'s
backward kernel, attention through ``flash_attention``'s:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
      --steps 5 --batch 8 --seq 512
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.api import resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training import (
    AdamWConfig,
    CheckpointManager,
    Prefetcher,
    SyntheticStream,
    TrainConfig,
    adamw_init,
    make_train_step,
)
from repro_torch.training.optimizer import leaves


class StepRecord(NamedTuple):
    step: int            # 1-based: the optimizer's step after it
    loss: float
    grad_norm: float
    lr: float
    seconds: float       # host clock around the step; it ends in the metrics' host read


def train(cfg: ModelConfig, train_cfg: TrainConfig, *, steps: int, batch: int, seq: int,
          seed: int = 0, ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          device="cuda", source=None, log_every: int = 5):
    """Train ``cfg`` from random parameters (seed ``seed``) for ``steps``
    steps of ``batch`` × ``seq`` tokens from ``source`` (default the
    :class:`SyntheticStream` of ``seed``), resuming from the latest
    checkpoint in ``ckpt_dir`` and saving one every ``ckpt_every`` steps and
    at the end.  Returns ``(params, opt_state, records)``, one
    :class:`StepRecord` per step run."""
    device = resolve_device(device)
    step_fn = make_train_step(cfg, train_cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt_state = adamw_init(params)
    print(f"arch={cfg.name} params={sum(x.numel() for x in leaves(params)):,}")

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and mgr.latest_step() is not None:
        start_step, (params, opt_state) = mgr.restore((params, opt_state))
        print(f"restored checkpoint at step {start_step}")

    stream = source if source is not None else SyntheticStream(cfg.vocab_size, batch, seq,
                                                               seed=seed)
    prefetch = Prefetcher(stream, start_step, device=device)
    records = []
    t_last, tok_acc = time.perf_counter(), 0
    try:
        for step in range(start_step, steps):
            _, data = next(prefetch)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, data)
            records.append(StepRecord(step + 1, metrics["loss"], metrics["grad_norm"],
                                      metrics["lr"], time.perf_counter() - t0))
            tok_acc += batch * seq
            if (step + 1) % log_every == 0 or step == start_step:
                dt = time.perf_counter() - t_last
                print(f"step {step + 1:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} lr={metrics['lr']:.2e} "
                      f"tok/s={tok_acc / max(dt, 1e-9):,.0f}")
                t_last, tok_acc = time.perf_counter(), 0
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))
    finally:
        prefetch.close()
    if mgr:
        mgr.save(steps, (params, opt_state), blocking=True)
        print(f"final checkpoint: step {steps} -> {ckpt_dir}")
    return params, opt_state, records


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, loss_chunk=64)
    train_cfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )
    return train(cfg, train_cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 device=args.device)


if __name__ == "__main__":
    main()
