"""Sharding rules of the port: logical axes to mesh axes for parameters,
optimizer state and batches (counterpart of ``repro.distributed.sharding``).

Mesh axes (:mod:`repro_torch.launch.mesh`): ``('data', 'model')`` on one
pod and ``('pod', 'data', 'model')`` across pods; ``pod`` acts as an outer
data axis.  The rules are the reference's, as pure functions of the
config, a leaf's path and shape, and the mesh's axis names and sizes:

* vocab, d_ff, expert and head dims go to ``model`` (TP / EP) when the
  axis divides them, else the leaf is replicated;
* batches go to ``(pod, data)``;
* AdamW's float32 ``m``, ``v`` and ``master`` are further split over the
  data axes on their largest divisible free dim (ZeRO);
* MCTS tree statistics are replicated; the wave's slots split over
  ``(pod, data)`` (:func:`constrain_search_batch`): each rank runs the
  rollouts of its own slots and the results come back to every rank, the
  paper's master-worker split.

A spec is a :class:`PartitionSpec`: one entry per tensor dim, ``None``, an
axis name, or a tuple of names split major to minor.  The specs are
computed on an :func:`abstract_mesh` (names and sizes, no devices) or on a
live ``torch.distributed.device_mesh.DeviceMesh``, whose placements
(:func:`spec_placements`: ``Shard(d)`` on each mesh dim whose axis appears
at tensor dim ``d``, ``Replicate()`` on the others) place DTensors.  DTensor
then propagates placements through the aten ops as GSPMD propagates specs;
the hand-written kernels, which read raw pointers, run on each rank's
shards through ``local_map`` (``models/layers.py``, ``models/ssm.py``).

Torch has no ambient mesh: :func:`use_mesh` installs one in a context
variable, :func:`ambient_abstract_mesh` reads it, and :func:`constrain`,
:func:`constrain_search_batch` and the expert-parallel MoE act only under
it.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:   # the models import this module
    from ..models.config import ModelConfig

Pytree = Any

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class PartitionSpec(tuple):
    """A tuple of per-dim entries: ``None``, an axis name, or a tuple of
    axis names (the dim split over their product, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes without devices: what the spec rules read."""

    def __init__(self, axis_sizes, axis_names):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(axis_sizes, axis_names)


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a ``DeviceMesh``)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an abstract mesh or a ``DeviceMesh``."""
    return tuple(mesh.mesh_dim_names) if _is_device_mesh(mesh) else tuple(mesh.axis_names)


def _device_mesh_sizes(mesh) -> list[int]:
    """A ``DeviceMesh``'s dim sizes (``size(i)``: its ``mesh`` tensor is
    rebuilt at every read)."""
    return [mesh.size(i) for i in range(mesh.ndim)]


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, _device_mesh_sizes(mesh)))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def logical_spec(mesh, *axes) -> PartitionSpec:
    """PartitionSpec with axes not present in the mesh dropped."""
    names = set(axis_names(mesh))

    def keep(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x in names)
            return kept if kept else None
        return a if a in names else None

    return P(*(keep(a) for a in axes))


def use_mesh(mesh):
    """Context manager installing ``mesh`` (abstract or a ``DeviceMesh``)
    as the ambient mesh.  Under a ``DeviceMesh`` a plain tensor that meets
    a DTensor counts as replicated (DTensor's ``implicit_replication``):
    the positions, masks and scalars the model makes for itself."""

    @contextlib.contextmanager
    def scope():
        token = _AMBIENT.set(mesh)
        try:
            if _is_device_mesh(mesh):
                from torch.distributed.tensor.experimental import implicit_replication

                with implicit_replication():
                    yield mesh
            else:
                yield mesh
        finally:
            _AMBIENT.reset(token)

    return scope()


def ambient_abstract_mesh():
    """The mesh installed by :func:`use_mesh`, or ``None``."""
    return _AMBIENT.get()


def _entry_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fit_spec(shape, spec, mesh) -> PartitionSpec:
    """``spec`` with every entry whose axes do not divide its dim dropped."""
    sizes = _mesh_axis_sizes(mesh)
    fixed = []
    for dim, a in zip(shape, spec):
        parts = 1
        for name in _entry_names(a):
            parts *= sizes[name]
        fixed.append(a if a is not None and dim % parts == 0 else None)
    return P(*fixed)


# ---------------------------------------------------------------------------
# Specs to DTensor placements
# ---------------------------------------------------------------------------


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, mesh dim by mesh dim:
    ``Shard(d)`` where the mesh axis appears at tensor dim ``d``,
    ``Replicate()`` elsewhere.  DTensor splits a dim sharded over several
    mesh dims in mesh order, major to minor, so a tuple entry must list its
    axes in mesh order (the reference's rules always do)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        members = _entry_names(entry)
        order = [names.index(a) for a in members]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for a in members:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def local_slice(x: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``placements``
    (even splits; a view when nothing is split)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    sizes = _device_mesh_sizes(mesh)
    parts = {}
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, idx = parts.get(pl.dim, (1, 0))
            parts[pl.dim] = (n * sizes[i], idx * sizes[i] + coord[i])
    for d, (n, idx) in parts.items():
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split {n} ways")
        step = x.shape[d] // n
        x = x.narrow(d, idx * step, step)
    return x.contiguous() if parts else x


def distribute_leaf(x: torch.Tensor, placements, mesh):
    """A DTensor of ``x`` (whole on every rank) under ``placements``; each
    rank keeps its own block, no communication."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_slice(x, placements, mesh), mesh, tuple(placements),
                              run_check=False)


def _tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def distribute_params(params: Pytree, specs: Pytree, mesh) -> Pytree:
    """Place a parameter tree (nested dicts, every leaf whole on every rank)
    on ``mesh``: each leaf becomes a DTensor holding this rank's block of
    its :class:`PartitionSpec`."""
    return _tree_map(lambda x, spec: distribute_leaf(x, spec_placements(spec, mesh), mesh),
                     params, specs)


def constrain(x, *axes):
    """Redistribute the DTensor ``x`` to the spec of ``axes`` on the ambient
    mesh, dropping axes that do not divide their dim; a no-op outside
    :func:`use_mesh` and for a plain tensor."""
    from torch.distributed.tensor import DTensor

    mesh = ambient_abstract_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _fit_spec(x.shape, logical_spec(mesh, *axes), mesh)
    pl = spec_placements(spec, x.device_mesh)
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def constrain_search_batch(pytree: Pytree) -> Pytree:
    """Split the leading slot axis of every leaf over ``(pod, data)``.

    The ``constrain`` hook of the search engines, applied to phase 2's slot
    arguments and again to its results.  A whole tensor (the master's,
    on every rank) becomes a DTensor holding this rank's slots; the engine
    runs the rollouts on each rank's slots (:func:`local_apply`); a DTensor
    result comes back whole to every rank, where the tree statistics stay
    replicated.  A no-op outside a ``DeviceMesh`` context, and for leaves
    whose leading dim the data axes do not divide.
    """
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map

    mesh = ambient_abstract_mesh()
    if mesh is None or not _is_device_mesh(mesh):
        return pytree

    def one(x):
        if isinstance(x, DTensor):
            return _gather(x)
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        spec = _fit_spec(x.shape, logical_spec(mesh, ("pod", "data"),
                                               *([None] * (x.dim() - 1))), mesh)
        if spec[0] is None:
            return x
        return distribute_leaf(x, spec_placements(spec, mesh), mesh)

    return tree_map(one, pytree)


def gather_blocks(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor of every rank's block ``x`` under ``placements``,
    on every rank (bool through uint8, which every backend gathers, cast
    on the block, outside DTensor's dispatch)."""
    from torch.distributed.tensor import DTensor

    y = x.to(torch.uint8) if x.dtype == torch.bool else x
    whole = DTensor.from_local(y, mesh, tuple(placements), run_check=False).full_tensor()
    return whole.to(torch.bool) if x.dtype == torch.bool else whole


def _gather(x):
    """The whole tensor of a DTensor, on every rank."""
    if x.dtype == torch.bool:
        return gather_blocks(x.to_local(), x.device_mesh, x.placements)
    return x.full_tensor()


def local_apply(fn: Callable, args: tuple):
    """``fn(*args)``; where ``args`` hold DTensors (slots placed by
    :func:`constrain_search_batch`), ``fn`` runs on this rank's blocks and
    its tensor results are DTensors of the same placement."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten, tree_map

    placed = [x for x in tree_flatten(args)[0] if isinstance(x, DTensor)]
    if not placed:
        return fn(*args)
    mesh, pl = placed[0].device_mesh, placed[0].placements
    out = fn(*tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, args))
    return tree_map(lambda y: DTensor.from_local(y, mesh, pl, run_check=False)
                    if isinstance(y, torch.Tensor) and y.dim() > 0 else y, out)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _tp_ok(dim: int, mesh, axis: str = "model") -> bool:
    sizes = _mesh_axis_sizes(mesh)
    return axis in sizes and dim % sizes[axis] == 0


def _param_rule(cfg: ModelConfig, path: str, shape: tuple, mesh) -> PartitionSpec:
    tp = "model"

    def heads_shardable(n_heads):
        return _tp_ok(n_heads, mesh)

    # --- embeddings / head ---
    if path.endswith("embed"):
        return logical_spec(mesh, tp, None) if _tp_ok(shape[0], mesh) else P()
    if path.endswith("lm_head"):
        return logical_spec(mesh, None, tp) if _tp_ok(shape[1], mesh) else P()

    # --- attention ---
    if re.search(r"(attn|cross)/w[qkvo]$", path) or re.search(r"(attn|cross)/b[qkv]$", path):
        n_heads = cfg.num_heads if re.search(r"w[qo]|bq", path) else cfg.num_kv_heads
        if not heads_shardable(n_heads):
            return P()  # replicate: attention falls back to pure DP
        if path.endswith("wo"):
            return logical_spec(mesh, tp, None)
        if re.search(r"b[qkv]$", path):
            return logical_spec(mesh, tp)
        return logical_spec(mesh, None, tp)

    # --- dense MLP / shared expert ---
    if re.search(r"(mlp|shared)/w_(gate|up)$", path):
        return logical_spec(mesh, None, tp) if _tp_ok(shape[-1], mesh) else P()
    if re.search(r"(mlp|shared)/w_down$", path):
        return logical_spec(mesh, tp, None) if _tp_ok(shape[-2], mesh) else P()

    # --- MoE routed experts: EP over the expert dim ---
    if re.search(r"moe/w_(gate|up|down)$", path):
        return logical_spec(mesh, tp, None, None) if _tp_ok(shape[-3], mesh) else P()
    if path.endswith("router"):
        return P()

    # --- Mamba-2 ---
    if re.search(r"ssm/(in_[xz]|in_dt|conv_x)$", path):
        return logical_spec(mesh, None, tp) if _tp_ok(shape[-1], mesh) else P()
    if re.search(r"ssm/(A_log|dt_bias|D|norm)$", path):
        return logical_spec(mesh, tp) if _tp_ok(shape[-1], mesh) else P()
    if re.search(r"ssm/out$", path):
        return logical_spec(mesh, tp, None) if _tp_ok(shape[-2], mesh) else P()
    # in_B / in_C / conv_B / conv_C / norms / everything else: replicate.
    return P()


def _fsdp_rule(shape: tuple, mesh, axes: tuple[str, ...]) -> PartitionSpec:
    """ZeRO-3/FSDP: shard the largest divisible dim over all given axes."""
    sizes = _mesh_axis_sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes.get(a, 1)
    best, best_dim = None, 0
    for i, dim in enumerate(shape):
        if dim % total == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is None:
        return P()
    entries = [None] * len(shape)
    entries[best] = axes if len(axes) > 1 else axes[0]
    return P(*entries)


def param_partition_specs(cfg: ModelConfig, abstract_params: Pytree, mesh,
                          strategy: str = "tp") -> Pytree:
    """The spec of every leaf of a parameter tree, by its ``/``-joined path
    (the layer-stacked ``[L, ...]`` leaves unsharded on ``L``)."""
    names = axis_names(mesh)
    all_axes = tuple(a for a in ("pod", "data", "model") if a in names)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        key, shape = prefix[:-1], tuple(tree.shape)
        stacked = key.startswith(("blocks/", "encoder/blocks/"))
        tail = shape[1:] if stacked else shape
        if strategy == "fsdp":
            spec = _fsdp_rule(tail, mesh, all_axes)
        else:
            spec = _param_rule(cfg, key, tail, mesh)
        return P(None, *spec) if stacked else spec

    return walk(abstract_params, "")


def param_shardings(cfg: ModelConfig, abstract_params: Pytree, mesh,
                    strategy: str = "tp") -> Pytree:
    """DTensor placements of every parameter on the ``DeviceMesh``."""
    return _tree_map(lambda s: spec_placements(s, mesh),
                     param_partition_specs(cfg, abstract_params, mesh, strategy))


def _zero_shard(spec: PartitionSpec, shape: tuple, mesh) -> PartitionSpec:
    """Extend a TP spec with ZeRO sharding over the data axes: partition the
    largest still-unsharded, divisible dim over ('pod','data')."""
    dp = data_axes(mesh)
    if not dp:
        return spec
    used = set()
    for a in spec:
        used.update(_entry_names(a))
    if used & set(dp):  # already data-sharded (fsdp strategy)
        return spec
    sizes = _mesh_axis_sizes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i, (dim, a) in enumerate(zip(shape, entries)):
        if a is None and dim % dp_total == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is None:
        return spec
    entries[best] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def opt_state_partition_specs(cfg: ModelConfig, abstract_params: Pytree, mesh,
                              strategy: str = "tp"):
    """AdamW state specs: each moment's leaf the parameter's spec plus the
    ZeRO split over the data axes; the step replicated."""
    from ..training.optimizer import AdamWState

    pspecs = param_partition_specs(cfg, abstract_params, mesh, strategy)
    moment = _tree_map(lambda s, x: _zero_shard(s, tuple(x.shape), mesh), pspecs,
                       abstract_params)
    return AdamWState(step=P(), m=moment, v=moment, master=moment)


def opt_state_shardings(cfg: ModelConfig, abstract_params: Pytree, mesh,
                        abstract_opt: Pytree = None, strategy: str = "tp"):
    """AdamW state placements on the ``DeviceMesh``: param spec + ZeRO
    partition over the data axes (``abstract_opt`` is accepted for the
    reference's signature; the moments have the parameters' shapes)."""
    specs = opt_state_partition_specs(cfg, abstract_params, mesh, strategy)
    moment = _tree_map(lambda t: spec_placements(t, mesh), specs.m)
    return specs._replace(step=spec_placements(specs.step, mesh), m=moment, v=moment,
                          master=moment)


def batch_spec(mesh, strategy: str = "tp", global_batch: int | None = None) -> PartitionSpec:
    names = axis_names(mesh)
    if strategy == "fsdp":
        # Batch shards over ALL axes when divisible (single-pod: 256 = 16·16).
        axes = tuple(a for a in ("pod", "data", "model") if a in names)
        sizes = _mesh_axis_sizes(mesh)
        total = 1
        for a in axes:
            total *= sizes[a]
        if global_batch is None or global_batch % total == 0:
            return P(axes)
    dp = data_axes(mesh)
    return P(dp if len(dp) > 1 else (dp[0] if dp else None))


def batch_shardings(mesh, batch_abstract: Pytree, strategy: str = "tp",
                    global_batch: int | None = None) -> Pytree:
    """The batch's placements: every leaf split on its leading dim as
    :func:`batch_spec` says."""
    spec = batch_spec(mesh, strategy, global_batch)
    return _tree_map(lambda _: spec_placements(spec, mesh), batch_abstract)
