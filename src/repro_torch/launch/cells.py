"""(architecture × input-shape) cells of the dry run (counterpart of
``repro.launch.cells``).

Each LM cell carries:

* its step function: ``train_step`` for train shapes, ``prefill`` or
  ``decode_step`` for inference shapes;
* its arguments as ``meta`` tensors (parameters, optimizer state, caches,
  batches): shapes and dtypes, nothing allocated;
* their specs on the mesh (:class:`repro_torch.distributed.sharding.
  PartitionSpec` trees; on a live ``DeviceMesh`` the placements are
  ``spec_placements`` of them).

Every cell runs on a live ``DeviceMesh``: :func:`place_args` places
whole arguments (the cell's shapes, or a cut of them with the same
specs) by the cell's specs, and ``cell.fn`` runs on them under
``use_mesh``.  A decode cell places the token and the cache by
:func:`_cache_shardings`' mode; its attention runs the ``decode_attention``
kernel on each rank's rows, heads and slice of S, the slices merged by
their log-sum-exps (``models.layers.on_cache_shards``), so no cache
crosses the wire.  ``long_500k`` runs only for sub-quadratic archs
(ssm/hybrid); the skip is recorded, not silent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..configs import get_config, list_archs
from ..distributed.sharding import (
    P,
    _mesh_axis_sizes,
    axis_names,
    batch_spec,
    distribute_params,
    opt_state_partition_specs,
    param_partition_specs,
)
from ..models import abstract_params, decode_step, init_cache, prefill
from ..models.config import ModelConfig
from ..models.lm import tree_map
from ..training.optimizer import AdamWState
from ..training.train_step import TrainConfig, make_train_step

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

META = torch.device("meta")


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str
    fn: Any                      # the step function
    arg_specs: tuple             # meta tensors
    in_shardings: tuple          # PartitionSpec trees
    out_shardings: Any
    model_cfg: ModelConfig
    tokens_per_step: int         # for MODEL_FLOPS bookkeeping


def skip_reason(arch: str, shape: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return (
            "full-attention arch: long_500k requires sub-quadratic attention "
            "(assignment rule; see DESIGN.md §Arch-applicability)"
        )
    return None


def _pad_experts(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad routed experts to a multiple of the TP size for EP divisibility."""
    if cfg.family != "moe" or cfg.num_experts % tp == 0:
        return cfg
    padded = ((cfg.num_experts + tp - 1) // tp) * tp
    return dataclasses.replace(cfg, num_experts=padded, num_experts_real=cfg.num_experts)


def _batch_specs(cfg: ModelConfig, batch_size: int, seq_len: int) -> dict:
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    batch: dict[str, Any] = {}
    if cfg.family == "vlm":
        text = seq_len - cfg.num_patches
        batch["tokens"] = meta((batch_size, text), torch.int32)
        batch["patch_embeds"] = meta((batch_size, cfg.num_patches, cfg.d_model), cfg.dtype)
    else:
        batch["tokens"] = meta((batch_size, seq_len), torch.int32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = meta((batch_size, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return batch


def _cache_shardings(cfg: ModelConfig, cache_abs, mesh, *, kv_mode: str):
    """KV cache specs:

    * ``batch``      — B over data axes (default decode/prefill),
    * ``seq_data``   — S over data (batch=1 long-context SP decode),
    * ``batch+seq_model`` — B over data AND S over model: split-KV decode
      (flash-decoding), each model shard reducing its slice of S,
    * ``seq_all``    — batch=1 long context: S over every mesh axis.
    """
    dp = batch_spec(mesh)
    names = axis_names(mesh)

    def spec_for(path_key: str, leaf):
        nd = len(leaf.shape)
        if path_key.endswith("len"):
            return P()
        if "cross" in path_key:
            # Enc-dec cross KV is short (1500 frames) and rarely divides the
            # model axis: batch-shard only.
            return P(None, dp[0] if dp else None, None, None, None)
        if "kv" in path_key:
            # [L(or sites), B, S, H, D]
            if kv_mode == "seq_data":
                return P(None, None, dp[0] if dp else None, None, None)
            if kv_mode == "batch+seq_model":
                return P(None, dp[0] if dp else None, "model", None, None)
            if kv_mode == "seq_all":
                axes = tuple(a for a in ("pod", "data", "model") if a in names)
                return P(None, None, axes, None, None)
            return P(None, dp[0] if dp else None, None, None, None)
        if "ssm" in path_key:
            # conv: [L, B, K-1, C] / state: [L, B, H, P, N]
            entries = [None] * nd
            if kv_mode not in ("seq_data", "seq_all"):
                entries[1] = dp[0] if dp else None
            return P(*entries)
        return P()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return spec_for(prefix[:-1], tree)

    return walk(cache_abs, "")


def build_cell(arch: str, shape: str, mesh, cfg_overrides: Optional[dict] = None,
               strategy: str = "tp", kv_mode: Optional[str] = None) -> Cell:
    reason = skip_reason(arch, shape)
    if reason is not None:
        raise ValueError(f"cell ({arch}, {shape}) skipped: {reason}")
    spec = SHAPES[shape]
    tp = _mesh_axis_sizes(mesh).get("model", 1)
    cfg = _pad_experts(get_config(arch), tp)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    gb, sl = spec["global_batch"], spec["seq_len"]
    if kv_mode is None:
        kv_mode = "seq_data" if shape == "long_500k" else "batch"

    params_abs = abstract_params(cfg)
    pshard = param_partition_specs(cfg, params_abs, mesh, strategy)
    dp = batch_spec(mesh, strategy, gb)

    if spec["kind"] == "train":
        def f32(x):
            return torch.empty(x.shape, dtype=torch.float32, device=META)

        opt_abs = AdamWState(step=torch.empty((), dtype=torch.int32, device=META),
                             m=tree_map(f32, params_abs), v=tree_map(f32, params_abs),
                             master=tree_map(f32, params_abs))
        oshard = opt_state_partition_specs(cfg, params_abs, mesh, strategy)
        batch_abs = _batch_specs(cfg, gb, sl)
        bshard = {k: dp for k in batch_abs}
        step = make_train_step(cfg, TrainConfig())
        return Cell(arch=arch, shape=shape, kind="train", fn=step,
                    arg_specs=(params_abs, opt_abs, batch_abs),
                    in_shardings=(pshard, oshard, bshard),
                    out_shardings=(pshard, oshard, None), model_cfg=cfg,
                    tokens_per_step=gb * sl)

    if spec["kind"] == "prefill":
        cache_abs = init_cache(cfg, gb, sl, device=META)
        cshard = _cache_shardings(cfg, cache_abs, mesh, kv_mode=kv_mode)
        batch_abs = _batch_specs(cfg, gb, sl)
        bshard = {k: dp for k in batch_abs}

        def prefill_fn(params, batch, cache):
            return prefill(params, cfg, batch, cache)

        return Cell(arch=arch, shape=shape, kind="prefill", fn=prefill_fn,
                    arg_specs=(params_abs, batch_abs, cache_abs),
                    in_shardings=(pshard, bshard, cshard), out_shardings=(dp, cshard),
                    model_cfg=cfg, tokens_per_step=gb * sl)

    # decode: one new token against a seq_len-deep cache.
    cache_abs = init_cache(cfg, gb, sl, device=META)
    cshard = _cache_shardings(cfg, cache_abs, mesh, kv_mode=kv_mode)
    token_abs = torch.empty((gb,), dtype=torch.int32, device=META)
    tshard = dp if kv_mode not in ("seq_data", "seq_all") else P()

    def decode_fn(params, token, cache):
        return decode_step(params, cfg, token, cache)

    return Cell(arch=arch, shape=shape, kind="decode", fn=decode_fn,
                arg_specs=(params_abs, token_abs, cache_abs),
                in_shardings=(pshard, tshard, cshard), out_shardings=(tshard, cshard),
                model_cfg=cfg, tokens_per_step=gb)


def place_args(cell: Cell, mesh, args: tuple) -> tuple:
    """``args`` (trees of whole tensors, each rank holding all of them)
    placed on the ``DeviceMesh`` by ``cell.in_shardings``: every leaf a
    DTensor of its spec (a decode cell's token and cache, the cache by its
    mode), the optimizer state's moments and master in their ZeRO
    placement, its step whole."""
    out = []
    for arg, specs in zip(args, cell.in_shardings):
        if isinstance(arg, AdamWState):
            out.append(AdamWState(step=arg.step, **{
                f: distribute_params(getattr(arg, f), getattr(specs, f), mesh)
                for f in ("m", "v", "master")}))
        else:
            out.append(distribute_params(arg, specs, mesh))
    return tuple(out)


def all_cells() -> list[tuple[str, str, Optional[str]]]:
    """Every (arch, shape) with its skip reason (None = runnable)."""
    return [(arch, shape, skip_reason(arch, shape)) for arch in list_archs()
            for shape in SHAPES]
