"""Training example: a policy LM trained with the whole substrate — data
pipeline, AdamW, gradient compression, a checkpoint and a restart after a
crash (the port's counterpart of ``examples/train_policy.py``).

The CPU-scale version of the rollout-policy training the paper's systems
perform (A3C for Joy City, PPO distillation for Atari, App. C/D); the same
loop (``repro_torch.launch.train``) trains the full-width configurations
on the card.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_policy [--device cpu]
      PYTHONPATH=src python -m repro_torch.examples.train_policy --model-100m
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_reduced
from repro_torch.core.api import resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training import (
    AdamWConfig,
    CheckpointManager,
    SyntheticStream,
    TrainConfig,
    adamw_init,
    make_train_step,
)
from repro_torch.training.data import to_device
from repro_torch.training.optimizer import leaves


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--model-100m", action="store_true",
                    help="~100M-parameter config (slow on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.model_100m:
        cfg = ModelConfig(name="policy-100m", family="dense", num_layers=8, d_model=768,
                          num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
                          dtype=torch.float32, attn_chunk=256, loss_chunk=128)
        batch, seq = 4, 256
    else:
        cfg = dataclasses.replace(get_reduced("llama3-8b"), loss_chunk=64)
        batch, seq = 8, 64

    ckpt_dir = tempfile.mkdtemp(prefix="wu_uct_policy_")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    print(f"model {cfg.name}: {sum(x.numel() for x in leaves(params)):,} params")

    tc = TrainConfig(
        optimizer=AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps),
        compress_grads=True,   # int8 error-feedback wire emulation
    )
    step = make_train_step(cfg, tc)    # updates params and state in place
    opt = adamw_init(params)
    stream = SyntheticStream(cfg.vocab_size, batch, seq, seed=0)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    losses = []

    half = args.steps // 2
    for s in range(half):
        params, opt, m = step(params, opt, to_device(stream.batch_at(s), device))
        losses.append(m["loss"])
        if (s + 1) % 10 == 0:
            print(f"step {s + 1}: loss={m['loss']:.4f}")
    mgr.save(half, (params, opt), blocking=True)
    print(f"checkpoint at step {half}; simulating crash + restart ...")

    # --- crash recovery: fresh state, restore, continue --------------------
    params2 = init_params(cfg, torch.Generator(device=device).manual_seed(42))  # a new job's
    opt2 = adamw_init(params2)
    start, (params2, opt2) = mgr.restore((params2, opt2))
    assert start == half
    last = start
    for s in range(start, args.steps):
        params2, opt2, m = step(params2, opt2, to_device(stream.batch_at(s), device))
        losses.append(m["loss"])
        last = s + 1
        if (s + 1) % 10 == 0:
            print(f"step {s + 1}: loss={m['loss']:.4f}")
    print("resumed training reached final step — elastic restart path works")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"restored_at": start, "last_step": last, "losses": losses}


if __name__ == "__main__":
    main()
