"""Counting the collectives a call issues on a live mesh (the counterpart of
the reference's ``dryrun.collective_bytes``, which reads them from the
partitioned HLO of a compiled cell; the port runs eagerly and has no HLO
to read, so it counts what is issued while the call runs).

:class:`CollectiveCounter` is a ``TorchDispatchMode``.  It lets DTensor
lower each of its ops first (it declines DTensor ops, as PyTorch's own
``CommDebugMode`` does) and then sees the collectives on the local
tensors: DTensor's redistributions, which run as functional collectives
(``torch.ops._c10d_functional``, ``torch.ops._dtensor``), and the explicit
``torch.distributed`` calls (``torch.ops.c10d``), such as the split-KV
merge's all-reduces.  Each one is counted by kind with its per-rank wire
bytes under the reference's ring model, ``n`` the group's size:

* all-gather: ``out_bytes * (n - 1) / n``;
* all-reduce: ``2 * bytes * (n - 1) / n``;
* reduce-scatter: ``out_bytes * (n - 1)``;
* all-to-all: ``bytes * (n - 1) / n``;
* collective-permute (a broadcast here): ``bytes`` when ``n > 1``.

A group of one rank moves nothing: its collectives count, with 0 bytes.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_OPS = {
    "_c10d_functional": {
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "all_reduce": "all-reduce",
        "all_reduce_coalesced": "all-reduce",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all",
        "broadcast": "collective-permute",
    },
    "_dtensor": {"shard_dim_alltoall": "all-to-all"},
    "c10d": {
        "allgather_": "all-gather",
        "_allgather_base_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "allreduce_": "all-reduce",
        "allreduce_coalesced_": "all-reduce",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "reduce_scatter_tensor_coalesced_": "reduce-scatter",
        "alltoall_": "all-to-all",
        "alltoall_base_": "all-to-all",
        "broadcast_": "collective-permute",
    },
}


def _ops() -> dict:
    """Collective op packets -> kind, for the ops this torch build has."""
    table = {}
    for namespace, ops in _OPS.items():
        space = getattr(torch.ops, namespace)
        for name, kind in ops.items():
            try:
                table[getattr(space, name)] = kind
            except (AttributeError, RuntimeError):
                continue
    return table


def _group_size(args) -> int:
    """The size of the group a collective's arguments name: a process
    group object (``torch.ops.c10d``) or a group's name (functional)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError(f"no process group among the collective's arguments {args!r}")


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _out_bytes(out, args) -> int:
    """The bytes of a collective's result: its return value (functional)
    or, for the in-place c10d ops, their first (output) argument."""
    got = _tensor_bytes(out if not isinstance(out, tuple) else out[0])
    return got or _tensor_bytes(args[0])


def wire_bytes(kind: str, nbytes: int, n: int) -> float:
    """Per-rank wire bytes of one collective (module docstring), ``nbytes``
    its result's bytes on one rank, ``n`` the group's size."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(nbytes * (n - 1))
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as c: fn(...)``; then :meth:`result`.

    ``events`` lists every collective seen: ``(kind, group size, result
    bytes on this rank, wire bytes)``."""

    def __init__(self):
        super().__init__()
        self._kinds = _ops()
        self.events: list[tuple[str, int, int, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor lower it to local ops first
        out = func(*args, **(kwargs or {}))
        kind = self._kinds.get(func._overloadpacket)
        if kind is not None:
            n = _group_size(args)
            nbytes = _out_bytes(out, args)
            self.events.append((kind, n, nbytes, wire_bytes(kind, nbytes, n)))
        return out

    def result(self) -> dict:
        """The reference's dict: per-rank wire bytes of each kind,
        ``total``, and ``counts`` of each kind."""
        out = {k: 0.0 for k in KINDS}
        counts = {k: 0 for k in KINDS}
        for kind, _, _, wire in self.events:
            out[kind] += wire
            counts[kind] += 1
        out["total"] = sum(out[k] for k in KINDS)
        out["counts"] = counts
        return out

