"""Dry run of the port's cells: for every (architecture × input-shape) cell
on a production mesh, what each rank holds and what the step computes,
from the specs and the ``meta`` shapes alone (nothing is allocated or run).

Per cell it reports the per-rank bytes of the parameters, the optimizer
state, the batch and the caches; the unsharded totals; ``model_flops``
(6·N·D for training, 2·N·D for inference, N the active parameters: the
reference's bookkeeping); and lower bounds on the step's time from the
published peaks of one NVIDIA H100 SXM, not from measurements.  Skipped
cells are listed with their reason.

The reference's dry run also compiles each cell and reads the collectives'
bytes from the partitioned HLO (``collective_bytes``, ``_shape_bytes``).
The port has no compiled program to read; its :func:`collective_bytes`
runs one call of a cell on a live ``DeviceMesh`` and counts what is
issued (:mod:`repro_torch.distributed.collectives`), in the reference's
dict.  The command line stays meta-only.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import torch

from ..distributed.collectives import CollectiveCounter
from ..distributed.sharding import _entry_names, _mesh_axis_sizes, use_mesh
from .cells import SHAPES, all_cells, build_cell, place_args, skip_reason
from .mesh import make_production_mesh, make_test_mesh

# NVIDIA H100 SXM5, published peaks (datasheet), not measurements.
PEAK_FLOPS = 989.4e12     # dense bf16 FLOP/s per card
HBM_BW = 3.35e12          # bytes/s per card (HBM3)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and not _is_spec_like(tree):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _is_spec_like(x) -> bool:
    from ..distributed.sharding import PartitionSpec

    return isinstance(x, PartitionSpec)


def _parts(spec, sizes: dict) -> int:
    n = 1
    for entry in spec:
        for name in _entry_names(entry):
            n *= sizes[name]
    return n


def per_rank_bytes(tree, specs, mesh_or_sizes) -> int:
    """Bytes one rank holds of ``tree`` (tensors or ``meta`` tensors)
    placed by ``specs`` (a matching tree of PartitionSpecs, or one spec for
    every leaf): each leaf's bytes over the product of the mesh axes its
    spec splits it on."""
    sizes = (mesh_or_sizes if isinstance(mesh_or_sizes, dict)
             else _mesh_axis_sizes(mesh_or_sizes))
    xs = _leaves(tree)
    ss = [specs] * len(xs) if _is_spec_like(specs) else _leaves(specs)
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves but {len(ss)} specs")
    return sum(x.numel() * x.element_size() // _parts(s, sizes) for x, s in zip(xs, ss))


def total_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def model_flops(cell, mesh_devices: int) -> float:
    """6·N·D bookkeeping (N = active params for MoE)."""
    n = cell.model_cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.tokens_per_step
    return 2.0 * n * cell.tokens_per_step


def collective_bytes(cell, mesh, args) -> dict:
    """Per-rank wire bytes of each collective kind, their ``total`` and
    ``counts``, of one call of ``cell.fn`` on the live ``DeviceMesh``
    ``mesh``: ``args`` (whole tensors, as for ``cells.place_args``) are
    placed by the cell's specs and the call runs under ``use_mesh`` (with
    no grad but for a train cell), counted as issued."""
    placed = place_args(cell, mesh, args)
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    with grad, use_mesh(mesh), CollectiveCounter() as counter:
        cell.fn(*placed)
    return counter.result()


def run_cell(arch: str, shape: str, mesh, mesh_name: str, overrides: Optional[dict] = None,
             strategy: str = "tp", kv_mode: Optional[str] = None) -> dict:
    cell = build_cell(arch, shape, mesh, cfg_overrides=overrides, strategy=strategy,
                      kv_mode=kv_mode)
    sizes = _mesh_axis_sizes(mesh)
    devices = math.prod(sizes.values())
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch", "cache"),
             "decode": ("params", "token", "cache")}[cell.kind]
    per_rank = {n: per_rank_bytes(a, s, sizes)
                for n, a, s in zip(names, cell.arg_specs, cell.in_shardings)}
    totals = {n: total_bytes(a) for n, a in zip(names, cell.arg_specs)}
    mf = model_flops(cell, devices)
    compute_s = mf / devices / PEAK_FLOPS
    memory_s = sum(per_rank.values()) / HBM_BW
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name, "devices": devices,
        "kind": cell.kind, "overrides": overrides or {}, "strategy": strategy,
        "kv_mode": kv_mode,
        "per_rank_bytes": per_rank,
        "total_bytes": totals,
        "model_flops": mf,
        # Lower bounds from the card's published peaks: the model's FLOPs
        # spread evenly, and one read of what a rank holds.
        "compute_s_bound": compute_s,
        "memory_s_bound": memory_s,
    }


MESHES = {
    "single_pod": lambda: make_production_mesh(multi_pod=False),
    "multi_pod": lambda: make_production_mesh(multi_pod=True),
    "test": lambda: make_test_mesh(multi_pod=False),
    "test_multi": lambda: make_test_mesh(multi_pod=True),
}


def _parse_overrides(text: Optional[str]) -> Optional[dict]:
    if not text:
        return None
    out = {}
    for kv in text.split(","):
        k, v = kv.split("=")
        out[k] = (v == "True" if v in ("True", "False") else float(v) if "." in v else int(v))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single_pod", choices=list(MESHES))
    ap.add_argument("--all", action="store_true", help="every cell")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--kv-mode", default=None,
                    choices=[None, "batch", "seq_data", "batch+seq_model", "seq_all"])
    ap.add_argument("--override", default=None,
                    help="comma list of cfg overrides, e.g. loss_chunk=512")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)
    mesh = MESHES[args.mesh]()
    if args.all:
        todo = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        todo = [(args.arch, args.shape, skip_reason(args.arch, args.shape))]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    records = []
    for arch, shape, reason in todo:
        tag = f"{arch}__{shape}__{args.mesh}"
        if reason is not None:
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh, "skipped": reason}
            print(f"SKIP {tag}: {reason}")
        else:
            rec = run_cell(arch, shape, mesh, args.mesh, overrides=overrides,
                           strategy=args.strategy, kv_mode=args.kv_mode)
            gib = {k: round(v / 2**30, 3) for k, v in rec["per_rank_bytes"].items()}
            print(f"ok   {tag}: per-rank GiB {gib} model_flops={rec['model_flops']:.4g} "
                  f"compute>={rec['compute_s_bound']:.4g}s memory>={rec['memory_s_bound']:.4g}s",
                  flush=True)
        if args.out:
            with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
                json.dump(rec, f, indent=2)
        elif not args.all:
            print(json.dumps(rec, indent=2))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
