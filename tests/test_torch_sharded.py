"""The port's multi-device layer on spawned gloo worlds on the CPU.

Two worlds, each spawned once for the file (``init_method=file://``, so no
port is taken; a 60 s process-group timeout and the parent's join limit
turn a hang into a failure): four ranks for a ``(2, 2)`` ``('data',
'model')`` mesh and a data-4 mesh, eight ranks for ``(2, 4)`` and ``(2, 2,
2)``.  The ranks import no JAX: the parent computes the reference's numbers
and hands them over with the inputs as ``.npz``.  Every parametrised case
reads the world's results.

* (a) each rank's block of every parameter is the slice its spec gives its
  mesh coordinates (an independent helper below), and its local bytes
  equal the dry run's per-rank figure;
* (b) the forward of all six families under ``tp`` on ``(2, 2)``: logits
  within rtol 1e-5 of one process, and of the JAX ``forward`` within the
  training tests' tolerances; the dense forward with the residual stream
  split over the sequence (``seq_shard_activations``) too;
* (c) one train step (loss, gradients, AdamW with the ZeRO state) for
  dense, moe and ssm under ``tp`` and dense under ``fsdp`` on ``(2, 2)``,
  against one process within the gradient tolerance.  The MoE step runs
  with capacity for every token and no router loss: sharded, the capacity
  counts a rank's tokens and the router loss is the mean of the ranks'
  (the reference's ``shard_map``), which (e) holds;
* (d) the dense forward on ``(2, 2, 2)``;
* (e) ``moe_block`` expert-parallel on ``(2, 4)`` (8 experts, 2 a rank,
  capacity factor 8) within 2e-4 of the JAX ``_moe_block_local`` and of the
  port's; its router loss is the mean of the data shards' and its
  gradients those of one process running each data shard on its own;
* (f) batched tap searches (B=8, W=4, wave and async engines) with
  ``constrain=constrain_search_batch`` on a data-4 mesh: bit for bit the
  one-process searches;
* (g) the search cell on ``(2, 2)`` with float32 parameters: one wave
  equals the reference's ``search_wave`` on one device, integer state
  exactly, values within rtol 1e-6, no rollout flipped;
* (h) the dense, ssm and hybrid prefill cells and the dense train cell,
  built on the ``(2, 2)`` mesh with the reduced configs as overrides,
  their arguments placed by the cells' own specs (the caches' among
  them): logits, caches and updated parameters against one process;
* (i) the decode cells of every family on ``(2, 2)`` and ``(2, 4)`` in the
  cache modes they use (dense in all four, moe in ``batch`` and split-KV
  ``batch+seq_model``, vlm and encdec in ``batch``, ssm in ``batch`` and
  ``long_500k``'s ``seq_data``, hybrid in ``seq_data`` and ``seq_all``),
  after a one-process prefill, with one KV head to ``model``'s 2 and 4
  (each rank's q heads part of one group): logits within rtol 1e-5, atol
  1e-6 of one process and of the JAX ``decode_step`` on the same
  parameters, the written caches of one process's; the collectives
  counted as issued: the same bytes at two cache lengths (no cache byte
  crosses the wire), and split-KV exactly the merge's bytes above
  ``batch`` (:func:`_merge_bytes`); ``dryrun.collective_bytes`` the same
  count;
* (j) the counter on one ``fsdp`` and one ``tp`` train step: ``fsdp``'s
  all-gathers carry at least every split parameter's ZeRO gather, and it
  reduce-scatters gradients;
* (k) a checkpoint of placed ``tp`` state (parameters, AdamW's ZeRO
  state) saved on ``(2, 2)``, restored onto a data-4 mesh by its specs
  there, leaf by leaf; the files read back through the JAX package's
  ``CheckpointManager``;
* (l) ``Prefetcher(mesh=)`` batches, gathered, equal the unplaced ones, by
  ``batch_spec`` and by a given spec.
"""

import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ARCHS = {"dense": "llama3-8b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
         "hybrid": "zamba2-7b", "vlm": "llava-next-mistral-7b", "encdec": "whisper-small"}
STEPS = [("dense", "tp"), ("moe", "tp"), ("ssm", "tp"), ("dense", "fsdp")]
# Capacity for every token: sharded, the capacity counts a rank's tokens.
FORWARD_OVERRIDES = {"moe": dict(capacity_factor=8.0)}
STEP_OVERRIDES = {"moe": dict(capacity_factor=8.0, router_aux_weight=0.0)}
MOE_E = dict(num_experts=8, capacity_factor=8.0)
CELL = dict(wave_size=8, num_simulations=32, d_mlp=256)
CELL_RUNS = [("dense", "prefill_32k"), ("ssm", "prefill_32k"), ("hybrid", "prefill_32k"),
             ("dense", "train_4k")]
# (i): one-process prefill of 6 tokens, then one placed decode step.  One
# KV head: model (2 or 4) divides the 4 q heads but not the KV heads.
DECODE_OVERRIDES = {"dense": dict(num_kv_heads=1), "vlm": dict(num_kv_heads=1),
                    "encdec": dict(num_kv_heads=1), "hybrid": dict(num_kv_heads=1),
                    "moe": dict(num_kv_heads=1, capacity_factor=8.0), "ssm": {}}
DECODE_CELLS = [("dense", "decode_32k", m) for m in ("batch", "batch+seq_model", "seq_data",
                                                    "seq_all")]
DECODE_CELLS += [("moe", "decode_32k", "batch"), ("moe", "decode_32k", "batch+seq_model"),
                 ("vlm", "decode_32k", "batch"), ("encdec", "decode_32k", "batch"),
                 ("ssm", "decode_32k", "batch"), ("ssm", "long_500k", "seq_data"),
                 ("hybrid", "long_500k", "seq_data"), ("hybrid", "long_500k", "seq_all")]
PROMPT = 6
DECODE_MAX_LENS = (16, 32)       # cache lengths: 8 parts of S at most
JOIN_LIMIT = 240.0
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S = 4, 16


def _batch(cfg, seed):
    g = np.random.default_rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = g.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = g.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(arrays, prefix):
    tree = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# The ranks (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(world, rank, size, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=60))
    try:
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        out = {"four": _world_four, "eight": _world_eight}[world](rank, inputs, tmp)
        np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _port(family, overrides=None):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(ARCHS[family]), **(overrides or {}))


def _params(inputs, family, cfg):
    from repro_torch import convert

    return convert.params_from_numpy(_nested(inputs, f"{family}/params/"), cfg, device="cpu")


def _torch_batch(inputs, family):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in _nested(inputs, f"{family}/batch/").items()}


def _expected_block(x, spec, coord):
    """The block of ``x`` that ``spec`` gives the mesh coordinates ``coord``
    ({axis: (index, size)}): each dim split over its entry's axes, the
    first axis major."""
    for d, entry in enumerate(spec):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in names:
            i, size = coord[a]
            idx, n = idx * size + i, n * size
        step = x.shape[d] // n
        x = x[(slice(None),) * d + (slice(idx * step, (idx + 1) * step),)]
    return x


def _check_blocks(out, tag, cfg, params, mesh, names, shape):
    """(a) on this rank, for both strategies."""
    from repro_torch.distributed.sharding import distribute_params, param_partition_specs
    from repro_torch.launch.dryrun import per_rank_bytes
    from repro_torch.models.lm import abstract_params
    from repro_torch.training.optimizer import leaves

    coord = {a: (c, s) for a, c, s in zip(names, mesh.get_coordinate(), shape)}
    for strategy in ("tp", "fsdp"):
        specs = param_partition_specs(cfg, params, mesh, strategy)
        placed = distribute_params(params, specs, mesh)
        ok, nbytes = True, 0
        for full, spec, leaf in zip(leaves(params), leaves_specs(specs), leaves(placed)):
            local = leaf.to_local()
            ok &= torch.equal(local, _expected_block(full, spec, coord))
            nbytes += local.numel() * local.element_size()
        out[f"{tag}/{strategy}/ok"] = np.array(ok)
        out[f"{tag}/{strategy}/bytes"] = np.array(nbytes)
        out[f"{tag}/{strategy}/dryrun"] = np.array(
            per_rank_bytes(abstract_params(cfg), specs, dict(zip(names, shape))))


def leaves_specs(specs):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in leaves_specs(specs[k])]
    return [specs]


def _forward_logits(cfg, params, batch, mesh):
    from repro_torch.distributed.sharding import (
        batch_spec, distribute_leaf, distribute_params, param_partition_specs,
        spec_placements, use_mesh)
    from repro_torch.models import forward

    placed = distribute_params(params, param_partition_specs(cfg, params, mesh, "tp"), mesh)
    pl = spec_placements(batch_spec(mesh, "tp", B), mesh)
    pb = {k: distribute_leaf(v, pl, mesh) for k, v in batch.items()}
    with torch.no_grad(), use_mesh(mesh):
        logits, _ = forward(placed, cfg, pb)
    return logits.full_tensor().numpy()


def _world_four(rank, inputs, tmp):
    from repro_torch.distributed.sharding import abstract_mesh
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import forward

    out = {}
    mesh = device_mesh(abstract_mesh((2, 2), ("data", "model")), "cpu")
    for family in ARCHS:
        cfg = _port(family, FORWARD_OVERRIDES.get(family))
        params = _params(inputs, family, cfg)
        batch = _torch_batch(inputs, family)
        _check_blocks(out, f"a/{family}/{rank}", cfg, params, mesh, ("data", "model"), (2, 2))
        out[f"b/{family}/sharded"] = _forward_logits(cfg, params, batch, mesh)
        with torch.no_grad():
            out[f"b/{family}/one"] = forward(params, cfg, batch)[0].numpy()
    cfg = _port("dense", {"seq_shard_activations": True})
    out["b/dense_seq/sharded"] = _forward_logits(cfg, _params(inputs, "dense", cfg),
                                                 _torch_batch(inputs, "dense"), mesh)
    for family, strategy in STEPS:
        _train_step(out, inputs, family, strategy, mesh)
    _cells_on_mesh(out, inputs, mesh)
    _decode_cells(out, inputs, mesh, "2x2")
    _checkpoint(out, inputs, mesh, tmp)
    _prefetch(out, mesh)
    _searches(out, rank)
    _search_cell(out, inputs, mesh)
    return out


def _counts_array(result):
    """A collective count (the reference's dict) as one array: the wire
    bytes of each kind, the total, the count of each kind."""
    from repro_torch.distributed.collectives import KINDS

    return np.array([result[k] for k in KINDS] + [result["total"]]
                    + [result["counts"][k] for k in KINDS], dtype=np.float64)


def _decode_cells(out, inputs, mesh, tag):
    """(i) each decode cell after a one-process prefill, at both cache
    lengths, its collectives counted; one process's step beside it."""
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.cells import build_cell, place_args
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.lm import tree_map
    from repro_torch.training.optimizer import leaves

    for family, shape, mode in DECODE_CELLS:
        cfg = _port(family, DECODE_OVERRIDES[family])
        params = _params(inputs, f"dec/{family}", cfg)
        batch = _torch_batch(inputs, f"dec/{family}")
        token = torch.from_numpy(inputs[f"dec/{family}/token"].astype(np.int64))
        over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "name"}
        cell = build_cell(ARCHS[family], shape, mesh, cfg_overrides=over, kv_mode=mode)
        key = f"i/{tag}/{family}/{mode}"
        for max_len in DECODE_MAX_LENS:
            with torch.no_grad():
                _, cache = prefill(params, cfg, batch, init_cache(cfg, B, max_len, device="cpu"))
                one, one_cache = decode_step(params, cfg, token, tree_map(torch.clone, cache))
                placed = place_args(cell, mesh, (params, token, tree_map(torch.clone, cache)))
                with use_mesh(mesh), CollectiveCounter() as counter:
                    got, got_cache = cell.fn(*placed)
            out[f"{key}/{max_len}/counts"] = _counts_array(counter.result())
            if max_len != DECODE_MAX_LENS[0]:
                continue
            out[f"{key}/one"] = one.numpy()
            out[f"{key}/sharded"] = got.full_tensor().numpy()
            for i, (a, b) in enumerate(zip(leaves(one_cache), leaves(got_cache))):
                out[f"{key}/cache/{i}/one"] = a.numpy()
                out[f"{key}/cache/{i}/sharded"] = (b.full_tensor() if hasattr(b, "full_tensor")
                                                   else b).numpy()
            if (family, mode) == ("dense", "batch"):
                out[f"{key}/dryrun"] = _counts_array(collective_bytes(cell, mesh, (
                    params, token, tree_map(torch.clone, cache))))


def _checkpoint(out, inputs, mesh, tmp):
    """(k) placed tp state saved on (2, 2), restored onto a data-4 mesh."""
    from repro_torch.distributed.sharding import (
        abstract_mesh, distribute_params, opt_state_partition_specs, opt_state_shardings,
        param_partition_specs, spec_placements)
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.training import CheckpointManager
    from repro_torch.training.checkpoint import _items
    from repro_torch.training.optimizer import adamw_init

    cfg = _port("dense")
    params = _params(inputs, "dense", cfg)
    placed = distribute_params(params, param_partition_specs(cfg, params, mesh, "tp"), mesh)
    opt = adamw_init(placed, opt_state_shardings(cfg, placed, mesh, None, "tp").m)
    directory = os.path.join(tmp, "ckpt")
    CheckpointManager(directory).save(3, (placed, opt), blocking=True)
    other = device_mesh(abstract_mesh((4, 1), ("data", "model")), "cpu")
    specs = (param_partition_specs(cfg, params, other, "tp"),
             opt_state_partition_specs(cfg, params, other, "tp"))
    step, state = CheckpointManager(directory).restore((placed, opt), mesh=other, specs=specs)
    whole = dict(_items((params, adamw_init(params))))
    wants = dict(_items(specs))
    ok, split = step == 3, 0
    for key, leaf in _items(state):
        if leaf.dim() == 0:
            ok &= not hasattr(leaf, "device_mesh") and torch.equal(leaf, whole[key])
            continue
        ok &= tuple(leaf.placements) == spec_placements(wants[key], other)
        ok &= torch.equal(leaf.full_tensor(), whole[key])
        split += leaf.to_local().numel() < leaf.numel()
    out["k/ok"] = np.array(bool(ok))
    out["k/split_leaves"] = np.array(split)


def _prefetch(out, mesh):
    """(l) placed batches against unplaced ones."""
    from repro_torch.distributed.sharding import P
    from repro_torch.training import Prefetcher, SyntheticStream

    stream = SyntheticStream(256, B, 8, seed=2)
    ok = True
    for specs, local in ((None, (B // 2, 8)), (P(None, "model"), (B, 4))):
        placed = Prefetcher(stream, 3, mesh=mesh, specs=specs)
        plain = Prefetcher(stream, 3, device="cpu")
        for _ in range(2):
            (s1, b1), (s2, b2) = next(placed), next(plain)
            ok &= s1 == s2 and torch.equal(b1["tokens"].full_tensor(), b2["tokens"])
            ok &= tuple(b1["tokens"].to_local().shape) == local
        placed.close()
        plain.close()
    out["l/ok"] = np.array(bool(ok))


def _cells_on_mesh(out, inputs, mesh):
    """(h) train and prefill cells built on the live mesh (the reduced
    config as overrides), their arguments placed by the cells' own specs,
    ``cell.fn`` run under the mesh, against one process."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.cells import build_cell, place_args
    from repro_torch.models import init_cache, prefill
    from repro_torch.models.lm import tree_map
    from repro_torch.training.optimizer import adamw_init, leaves
    from repro_torch.training.train_step import TrainConfig, make_train_step

    for family, shape in CELL_RUNS:
        cfg = _port(family)
        over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "name"}
        cell = build_cell(ARCHS[family], shape, mesh, cfg_overrides=over)
        batch = _torch_batch(inputs, family)
        tag = f"h/{family}/{shape}"
        if cell.kind == "prefill":
            cache = init_cache(cfg, B, S + 8, device="cpu")
            params = _params(inputs, family, cfg)
            with torch.no_grad():
                logits, new = prefill(params, cfg, batch, tree_map(torch.clone, cache))
                placed = place_args(cell, mesh, (params, batch, cache))
                with use_mesh(mesh):
                    got, got_cache = cell.fn(*placed)
            pairs = [(logits, got)] + list(zip(leaves(new), leaves(got_cache)))
        else:
            p1 = _params(inputs, family, cfg)
            p1, _, m1 = make_train_step(cfg, TrainConfig())(p1, adamw_init(p1), batch)
            p2 = _params(inputs, family, cfg)
            placed = place_args(cell, mesh, (p2, adamw_init(p2), batch))
            with use_mesh(mesh):
                p2, _, m2 = cell.fn(*placed)
            out[f"{tag}/loss"] = np.array([m1["loss"], m2["loss"]])
            pairs = list(zip(leaves(p1), leaves(p2)))
        for i, (a, b) in enumerate(pairs):
            out[f"{tag}/{i}/one"] = a.numpy()
            out[f"{tag}/{i}/sharded"] = b.full_tensor().numpy()


def _train_step(out, inputs, family, strategy, mesh):
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.sharding import (
        distribute_params, opt_state_shardings, param_partition_specs)
    from repro_torch.training.optimizer import adamw_init, leaves
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = _port(family, STEP_OVERRIDES.get(family))
    batch = _torch_batch(inputs, family)
    p1 = _params(inputs, family, cfg)
    p1, o1, m1 = make_train_step(cfg, TrainConfig())(p1, adamw_init(p1), batch)
    p2 = _params(inputs, family, cfg)
    specs = param_partition_specs(cfg, p2, mesh, strategy)
    p2 = distribute_params(p2, specs, mesh)
    o2 = adamw_init(p2, opt_state_shardings(cfg, p2, mesh, None, strategy).m)
    with CollectiveCounter() as counter:
        p2, o2, m2 = make_train_step(cfg, TrainConfig(), mesh=mesh, strategy=strategy)(
            p2, o2, batch)
    tag = f"c/{family}/{strategy}"
    # (j): every parameter split over the 4 ranks is gathered whole at least
    # once, 3/4 of its bytes on each rank's wire.
    out[f"{tag}/counts"] = _counts_array(counter.result())
    out[f"{tag}/zero_gather"] = np.array(sum(
        x.numel() * x.element_size() * 3 / 4 for x in leaves(p2)
        if x.to_local().numel() * 4 == x.numel()))
    for key in ("loss", "grad_norm"):
        out[f"{tag}/{key}"] = np.array([m1[key], m2[key]])
    for name, one, placed in (("params", p1, p2), ("m", o1.m, o2.m), ("v", o1.v, o2.v),
                              ("master", o1.master, o2.master)):
        for i, (a, b) in enumerate(zip(leaves(one), leaves(placed))):
            out[f"{tag}/{name}/{i}/one"] = a.numpy()
            out[f"{tag}/{name}/{i}/sharded"] = b.full_tensor().numpy()
    # The ZeRO state: each rank holds the bytes its specs give it.
    from repro_torch.distributed.sharding import opt_state_partition_specs
    from repro_torch.launch.dryrun import per_rank_bytes

    rank = torch.distributed.get_rank()
    ospecs = opt_state_partition_specs(cfg, o1.m, mesh, strategy)
    for name in ("m", "v", "master"):
        local = sum(x.to_local().numel() * 4 for x in leaves(getattr(o2, name)))
        out[f"{tag}/{name}_bytes/{rank}"] = np.array(
            [local, per_rank_bytes(getattr(o1, name), getattr(ospecs, name),
                                   {"data": 2, "model": 2}),
             sum(x.numel() * 4 for x in leaves(getattr(o1, name)))])


def _searches(out, rank):
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher
    from repro_torch.distributed.sharding import abstract_mesh, constrain_search_batch, use_mesh
    from repro_torch.envs import make_tap_game
    from repro_torch.launch.mesh import device_mesh

    mesh = device_mesh(abstract_mesh((4, 1), ("data", "model")), "cpu")
    env = make_tap_game()
    keys = rng.split(rng.PRNGKey(3, device="cpu"), 8)
    roots = env.init(keys)
    for engine in ("wave", "async"):
        spec = SearchSpec(algo="wu_uct", engine=engine, batch=8, num_simulations=8,
                          wave_size=4, max_depth=6, max_sim_steps=8, max_width=5, gamma=1.0)
        one = build_searcher(env, spec, device="cpu")(roots, keys)
        search = build_searcher(env, spec, device="cpu", constrain=constrain_search_batch)
        with use_mesh(mesh):
            sharded = search(roots, keys)
        for f in one._fields:
            out[f"f/{engine}/{f}/one"] = getattr(one, f).numpy()
            out[f"f/{engine}/{f}/sharded"] = getattr(sharded, f).numpy()


def _search_cell(out, inputs, mesh):
    from repro_torch import rng
    from repro_torch.core.batched_tree import init_batched_tree
    from repro_torch.launch.search_cell import build_search_cell, place_params

    cell = build_search_cell(mesh, **CELL)
    params = {k: torch.from_numpy(inputs[f"g/params/{k}"]) for k in ("w1", "b1", "w2")}
    root = cell.env.init(rng.PRNGKey(0, device="cpu")[None])
    tree = init_batched_tree(root, CELL["num_simulations"] + CELL["wave_size"] + 1,
                             cell.env.num_actions)
    tree = cell.fn(place_params(params, mesh), tree, rng.PRNGKey(1, device="cpu"))
    for f in tree._fields:
        if f == "states":
            for sf in tree.states._fields:
                out[f"g/states/{sf}"] = getattr(tree.states, sf)[0].numpy()
        else:
            out[f"g/{f}"] = getattr(tree, f)[0].numpy()


def _world_eight(rank, inputs, tmp):
    from repro_torch.distributed.sharding import abstract_mesh, distribute_leaf, use_mesh
    from repro_torch.distributed.sharding import spec_placements, P
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import forward
    from repro_torch.models.layers import _moe_block_local, moe_block

    out = {}
    mesh3 = device_mesh(abstract_mesh((2, 2, 2), ("pod", "data", "model")), "cpu")
    cfg = _port("dense")
    params = _params(inputs, "dense", cfg)
    batch = _torch_batch(inputs, "dense")
    _check_blocks(out, f"a/dense3/{rank}", cfg, params, mesh3, ("pod", "data", "model"),
                  (2, 2, 2))
    out["d/sharded"] = _forward_logits(cfg, params, batch, mesh3)
    with torch.no_grad():
        out["d/one"] = forward(params, cfg, batch)[0].numpy()

    mesh = device_mesh(abstract_mesh((2, 4), ("data", "model")), "cpu")
    # model = 4 splits the 4 q heads, not the 2 KV heads.
    out["d/sharded_2x4"] = _forward_logits(cfg, params, batch, mesh)
    _decode_cells(out, inputs, mesh, "2x4")
    cfg = _port("moe", MOE_E)
    from repro_torch.models.lm import tree_map

    bp = tree_map(torch.from_numpy, _nested(inputs, "e/params/"))
    x = torch.from_numpy(inputs["e/x"])
    r = torch.from_numpy(inputs["e/r"])
    placements = {"router": P(), "w_gate": P("model", None, None),
                  "w_up": P("model", None, None), "w_down": P("model", None, None)}
    live = {k: (distribute_leaf(v, spec_placements(placements[k], mesh), mesh)
                if k in placements else {n: distribute_leaf(w, spec_placements(P(), mesh), mesh)
                                         for n, w in v.items()})
            for k, v in bp.items()}
    for v in (live["router"], live["w_gate"], live["w_up"], live["w_down"]):
        v.requires_grad_()
    xs = distribute_leaf(x, spec_placements(P("data"), mesh), mesh).requires_grad_()
    with use_mesh(mesh):
        o, aux = moe_block(live, cfg, xs)
        total = (o * r).sum() + aux
        grads = torch.autograd.grad(total, [xs, live["router"], live["w_gate"], live["w_down"]])
    out["e/sharded"] = o.full_tensor().detach().numpy()
    out["e/aux_sharded"] = aux.full_tensor().detach().numpy()
    for name, g in zip(("x", "router", "w_gate", "w_down"), grads):
        out[f"e/grad/{name}/sharded"] = g.full_tensor().numpy()
    with torch.no_grad():
        out["e/local"] = _moe_block_local(bp, cfg, x)[0].numpy()
    # One process, each data shard on its own: the sharded block's semantics.
    ref = {k: v.clone().requires_grad_() if k != "shared" else v for k, v in bp.items()}
    xr = x.clone().requires_grad_()
    outs, auxes = zip(*(_moe_block_local(ref, cfg, part) for part in xr.chunk(2)))
    aux_mean = sum(auxes) / 2
    total = (torch.cat(outs) * r).sum() + aux_mean
    grads = torch.autograd.grad(total, [xr, ref["router"], ref["w_gate"], ref["w_down"]])
    out["e/aux_shards"] = aux_mean.detach().numpy()
    for name, g in zip(("x", "router", "w_gate", "w_down"), grads):
        out[f"e/grad/{name}/shards"] = g.numpy()
    return out


# ---------------------------------------------------------------------------
# The parent: the reference's numbers, the worlds, the cases
# ---------------------------------------------------------------------------


def _start(world, size, tmp, inputs):
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(world, r, size, tmp)) for r in range(size)]
    for p in procs:
        p.start()
    return procs


def _finish(world, procs, tmp, deadline):
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} of the {world} world did not finish in {JOIN_LIMIT} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{world} world exit codes {codes}"
    merged = {}
    for r in range(len(procs)):
        merged.update(dict(np.load(os.path.join(tmp, f"out_{r}.npz"))))
    return merged


def _port_params(family, cfg=None):
    """The port's seeded parameters as the reference's numpy tree."""
    from repro_torch.models import init_params
    from repro_torch.models.lm import tree_map

    cfg = cfg or _port(family)
    return tree_map(lambda x: x.numpy(), init_params(cfg, torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run at once; the parent computes the reference's numbers
    meanwhile."""
    four_in, eight_in = _cell_inputs(), {}
    for family in ARCHS:
        cfg = _port(family, FORWARD_OVERRIDES.get(family))
        four_in.update(_flat(_port_params(family, cfg), f"{family}/params/"))
        four_in.update(_flat(_batch(cfg, 7), f"{family}/batch/"))
    for family in DECODE_OVERRIDES:
        cfg = _port(family, DECODE_OVERRIDES[family])
        four_in.update(_flat(_port_params(family, cfg), f"dec/{family}/params/"))
        g = np.random.default_rng(9)
        prompt = _batch(cfg, 13)
        prompt["tokens"] = prompt["tokens"][:, :PROMPT]
        prompt.pop("patch_embeds", None)        # the vlm's decode cell runs on tokens
        four_in.update(_flat(prompt, f"dec/{family}/batch/"))
        four_in[f"dec/{family}/token"] = g.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    eight_in.update({k: v for k, v in four_in.items() if k.startswith(("dense/", "dec/"))})
    mcfg = _port("moe", MOE_E)
    bp = _port_params("moe", mcfg)["blocks"]["moe"]
    bp = {k: (v[0] if not isinstance(v, dict) else {n: w[0] for n, w in v.items()})
          for k, v in bp.items()}
    g = np.random.default_rng(11)
    x = g.normal(size=(4, 16, mcfg.d_model)).astype(np.float32)
    eight_in.update(_flat(bp, "e/params/"))
    eight_in["e/x"] = x
    eight_in["e/r"] = g.normal(size=x.shape).astype(np.float32)

    tmp4, tmp8 = (str(tmp_path_factory.mktemp(w)) for w in ("four", "eight"))
    deadline = time.monotonic() + JOIN_LIMIT
    procs4 = _start("four", 4, tmp4, four_in)
    procs8 = _start("eight", 8, tmp8, eight_in)
    try:
        refs = {"forward": _forward_reference(four_in), "moe": _moe_reference(bp, x),
                "cell": _cell_reference(four_in), "decode": _decode_reference(four_in)}
    finally:
        res4 = _finish("four", procs4, tmp4, deadline)
        res8 = _finish("eight", procs8, tmp8, deadline)
    return {"four": res4, "eight": res8, "ckpt": os.path.join(tmp4, "ckpt"),
            "inputs": four_in, **refs}


def _forward_reference(inputs):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.models import forward

    out = {}
    for family, arch in ARCHS.items():
        cfg = dataclasses.replace(get_reduced(arch), **FORWARD_OVERRIDES.get(family, {}))
        params = _nested(inputs, f"{family}/params/")
        batch = {k: jnp.asarray(v) for k, v in _nested(inputs, f"{family}/batch/").items()}
        out[family] = np.asarray(jax.jit(lambda p, b: forward(p, cfg, b)[0])(params, batch))
    return out


def _decode_reference(inputs):
    """The JAX ``decode_step`` after ``prefill`` on the same parameters,
    prompt and token, each family's logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.models import decode_step, init_cache, prefill

    out = {}
    for family, over in DECODE_OVERRIDES.items():
        cfg = dataclasses.replace(get_reduced(ARCHS[family]), **over)
        params = _nested(inputs, f"dec/{family}/params/")
        batch = {k: jnp.asarray(v) for k, v in _nested(inputs, f"dec/{family}/batch/").items()}

        def step(p, b, t):
            _, cache = prefill(p, cfg, b, init_cache(cfg, B, DECODE_MAX_LENS[0]))
            return decode_step(p, cfg, t, cache)[0]

        out[family] = np.asarray(jax.jit(step)(params, batch,
                                               jnp.asarray(inputs[f"dec/{family}/token"])))
    return out


def _moe_reference(bp, x):
    import jax
    from repro.configs import get_reduced
    from repro.models.layers import _moe_block_local

    cfg = dataclasses.replace(get_reduced(ARCHS["moe"]), **MOE_E)
    return np.asarray(jax.jit(lambda p, x: _moe_block_local(p, cfg, x)[0])(bp, x))


def _cell_inputs():
    g = np.random.default_rng(5)
    obs, d, a = 146, CELL["d_mlp"], 36
    return {"g/params/w1": (g.normal(size=(obs, d)) * 0.1).astype(np.float32),
            "g/params/b1": (g.normal(size=(d,)) * 0.1).astype(np.float32),
            "g/params/w2": (g.normal(size=(d, a)) * 0.1).astype(np.float32)}


def _cell_reference(inputs):
    import jax
    from repro.core import tree as tree_lib
    from repro.distributed.sharding import use_mesh
    from repro.launch.mesh import make_single_device_mesh
    from repro.launch.search_cell import build_search_cell

    mesh = make_single_device_mesh()
    cell = build_search_cell(mesh, **CELL)
    from repro.envs import make_tap_game

    env = make_tap_game(grid_size=6, num_colors=4, goal_count=12, step_budget=20)
    tree = tree_lib.init_tree(env.init(jax.random.PRNGKey(0)),
                              CELL["num_simulations"] + CELL["wave_size"] + 1, env.num_actions)
    params = {k: inputs[f"g/params/{k}"] for k in ("w1", "b1", "w2")}
    with use_mesh(mesh):
        out = jax.jit(cell.fn)(params, tree, jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("family", list(ARCHS))
def test_blocks_are_the_specs_slices(worlds, family):
    res = worlds["four"]
    for rank in range(4):
        for strategy in ("tp", "fsdp"):
            tag = f"a/{family}/{rank}/{strategy}"
            assert bool(res[f"{tag}/ok"]), tag
            assert int(res[f"{tag}/bytes"]) == int(res[f"{tag}/dryrun"]), tag


def test_blocks_on_the_three_axis_mesh(worlds):
    res = worlds["eight"]
    for rank in range(8):
        for strategy in ("tp", "fsdp"):
            tag = f"a/dense3/{rank}/{strategy}"
            assert bool(res[f"{tag}/ok"]), tag
            assert int(res[f"{tag}/bytes"]) == int(res[f"{tag}/dryrun"]), tag


@pytest.mark.parametrize("family", list(ARCHS))
def test_forward_under_tp(worlds, family):
    res = worlds["four"]
    sharded = res[f"b/{family}/sharded"]
    np.testing.assert_allclose(sharded, res[f"b/{family}/one"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sharded, worlds["forward"][family], **GRAD_TOL)


def test_forward_with_the_sequence_split(worlds):
    """``seq_shard_activations``: the residual stream split over the
    sequence and ``model`` at block entries changes no logit."""
    res = worlds["four"]
    np.testing.assert_allclose(res["b/dense_seq/sharded"], res["b/dense/one"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family,strategy", STEPS)
def test_train_step(worlds, family, strategy):
    res = worlds["four"]
    tag = f"c/{family}/{strategy}"
    one, sharded = res[f"{tag}/loss"]
    np.testing.assert_allclose(sharded, one, **LOSS_TOL)
    one, sharded = res[f"{tag}/grad_norm"]
    np.testing.assert_allclose(sharded, one, **GRAD_TOL)
    n = 0
    for name in ("params", "m", "v", "master"):
        i = 0
        while f"{tag}/{name}/{i}/one" in res:
            np.testing.assert_allclose(res[f"{tag}/{name}/{i}/sharded"],
                                       res[f"{tag}/{name}/{i}/one"], **GRAD_TOL,
                                       err_msg=f"{tag} {name} leaf {i}")
            i += 1
        n += i
    assert n > 0
    # ZeRO: each rank's moments and master are the bytes the specs give it,
    # under half the whole (the data axes split them on top of the specs).
    for rank in range(4):
        for name in ("m", "v", "master"):
            local, spec_bytes, whole = res[f"{tag}/{name}_bytes/{rank}"]
            assert local == spec_bytes, (tag, name, rank)
            assert local < whole / 2, (tag, name, rank)


@pytest.mark.parametrize("family,shape", CELL_RUNS)
def test_cells_run_on_the_mesh(worlds, family, shape):
    res = worlds["four"]
    tag = f"h/{family}/{shape}"
    if f"{tag}/loss" in res:
        np.testing.assert_allclose(res[f"{tag}/loss"][1], res[f"{tag}/loss"][0], **LOSS_TOL)
    i = 0
    while f"{tag}/{i}/one" in res:
        np.testing.assert_allclose(res[f"{tag}/{i}/sharded"], res[f"{tag}/{i}/one"],
                                   **GRAD_TOL, err_msg=f"{tag} leaf {i}")
        i += 1
    assert i > 1


@pytest.mark.parametrize("mesh_name", ["2x2x2", "2x4"])
def test_dense_forward_on_the_eight_rank_meshes(worlds, mesh_name):
    """``(2, 2, 2)``, and ``(2, 4)``, where ``model`` splits the q heads
    but not the KV heads: each rank's q heads get their KV heads."""
    res = worlds["eight"]
    key = "d/sharded" if mesh_name == "2x2x2" else "d/sharded_2x4"
    np.testing.assert_allclose(res[key], res["d/one"], rtol=1e-5, atol=1e-6)


def test_expert_parallel_moe(worlds):
    res, ref = worlds["eight"], worlds["moe"]
    np.testing.assert_allclose(res["e/sharded"], ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res["e/sharded"], res["e/local"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(res["e/aux_sharded"], res["e/aux_shards"], rtol=1e-6)
    for name in ("x", "router", "w_gate", "w_down"):
        np.testing.assert_allclose(res[f"e/grad/{name}/sharded"],
                                   res[f"e/grad/{name}/shards"], **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("engine", ["wave", "async"])
def test_search_batch_split_over_data(worlds, engine):
    res = worlds["four"]
    keys = [k for k in res if k.startswith(f"f/{engine}/") and k.endswith("/one")]
    assert len(keys) == 8
    for k in keys:
        np.testing.assert_array_equal(res[k[:-len("one")] + "sharded"], res[k], err_msg=k)


def test_search_cell_wave(worlds):
    res, ref = worlds["four"], worlds["cell"]
    for f in ("parent", "action", "children", "terminal", "pending", "depth", "size",
              "overflowed"):
        np.testing.assert_array_equal(res[f"g/{f}"], np.asarray(getattr(ref, f)), err_msg=f)
    for sf in ref.states._fields:
        np.testing.assert_array_equal(res[f"g/states/{sf}"], np.asarray(getattr(ref.states, sf)),
                                      err_msg=sf)
    # A flipped rollout would move a value by far more than rounding.
    flips = 0
    for f in ("N", "O", "V", "VL", "R"):
        got, want = res[f"g/{f}"], np.asarray(getattr(ref, f))
        flips += int(np.sum(~np.isclose(got, want, rtol=1e-6, atol=0)))
    assert flips == 0
    assert int(res["g/size"]) > 1


def _merge_bytes(cfg, rows, model):
    """Per-rank wire bytes of the split-KV merge above ``batch`` mode, for
    one decode step of ``cfg`` with ``rows`` rows a data rank and S split
    over ``model`` ranks, the model's q heads split over them too: per
    layer, q's heads all-gathered (``rows·Hq·D`` float32 gathered, ``(m -
    1)/m`` of it on the wire), then two all-reduces of the merge, the max
    of ``lse [rows, Hq]`` and the weighted sums ``[rows, Hq, D + 1]``
    (``2·bytes·(m - 1)/m`` each)."""
    f = (model - 1) / model
    hq, d = cfg.num_heads, cfg.head_dim
    per_layer = (rows * hq * d * 4 * f + 2 * rows * hq * 4 * f
                 + 2 * rows * hq * (d + 1) * 4 * f)
    return cfg.num_layers * per_layer


MESHES = {"2x2": ("four", 2, 2), "2x4": ("eight", 2, 4)}


@pytest.mark.parametrize("family,shape,mode", DECODE_CELLS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_decode_cells_on_the_mesh(worlds, mesh_name, family, shape, mode):
    """(i) logits of one process and of the JAX ``decode_step``, the cache
    of one process, and no cache byte on the wire: the same collectives at
    both cache lengths."""
    res = worlds[MESHES[mesh_name][0]]
    key = f"i/{mesh_name}/{family}/{mode}"
    got = res[f"{key}/sharded"]
    np.testing.assert_allclose(got, res[f"{key}/one"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, worlds["decode"][family], rtol=1e-5, atol=1e-6)
    i = 0
    while f"{key}/cache/{i}/one" in res:
        np.testing.assert_allclose(res[f"{key}/cache/{i}/sharded"], res[f"{key}/cache/{i}/one"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"{key} cache leaf {i}")
        i += 1
    assert i >= 3
    a, b = (res[f"{key}/{n}/counts"] for n in DECODE_MAX_LENS)
    np.testing.assert_array_equal(a, b, err_msg=f"{key}: collectives change with the cache")


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_split_kv_moves_only_the_merge(worlds, mesh_name, family):
    """(i) ``batch+seq_model`` above ``batch``: exactly the merge's bytes
    (:func:`_merge_bytes`), one all-gather and two all-reduces a layer."""
    from repro_torch.distributed.collectives import KINDS

    world, data, model = MESHES[mesh_name]
    res = worlds[world]
    split, batch = (res[f"i/{mesh_name}/{family}/{m}/{DECODE_MAX_LENS[0]}/counts"]
                    for m in ("batch+seq_model", "batch"))
    cfg = _port(family, DECODE_OVERRIDES[family])
    diff = dict(zip(list(KINDS) + ["total"] + [f"n {k}" for k in KINDS], split - batch))
    np.testing.assert_allclose(diff["total"], _merge_bytes(cfg, B // data, model), rtol=1e-12)
    assert diff["n all-gather"] == cfg.num_layers
    assert diff["n all-reduce"] == 2 * cfg.num_layers
    assert diff["reduce-scatter"] == 0 and diff["all-to-all"] == 0


def test_dryrun_collective_bytes_counts_the_decode_cell(worlds):
    res = worlds["four"]
    key = "i/2x2/dense/batch"
    np.testing.assert_array_equal(res[f"{key}/dryrun"], res[f"{key}/{DECODE_MAX_LENS[0]}/counts"])
    assert res[f"{key}/dryrun"][5] > 0


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_train_step_collectives(worlds, strategy):
    """(j) ``fsdp``: the ZeRO all-gathers of the split parameters and the
    gradients' reduce-scatters; ``tp``: both kinds too (AdamW's ZeRO state
    over the data axes)."""
    from repro_torch.distributed.collectives import KINDS

    res = worlds["four"]
    counts = dict(zip(list(KINDS) + ["total"] + [f"n {k}" for k in KINDS],
                      res[f"c/dense/{strategy}/counts"]))
    assert counts["n all-gather"] > 0 and counts["n reduce-scatter"] > 0
    assert counts["reduce-scatter"] > 0
    if strategy == "fsdp":
        assert counts["all-gather"] >= res["c/dense/fsdp/zero_gather"] > 0


def test_placed_checkpoint_restores_onto_another_mesh(worlds):
    """(k) on the ranks; here the files through the JAX package."""
    import jax
    import jax.numpy as jnp
    from repro.training import CheckpointManager as JaxCheckpointManager
    from repro.training.optimizer import adamw_init as jax_adamw_init

    res = worlds["four"]
    assert bool(res["k/ok"]) and int(res["k/split_leaves"]) > 0
    params = _nested(worlds["inputs"], "dense/params/")
    like = (jax.tree.map(jnp.zeros_like, params),
            jax_adamw_init(jax.tree.map(jnp.zeros_like, params)))
    step, (jp, jopt) = JaxCheckpointManager(worlds["ckpt"]).restore(like)
    assert step == 3
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(jopt.master), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.astype(np.float32))


def test_prefetcher_places_batches(worlds):
    assert bool(worlds["four"]["l/ok"])
