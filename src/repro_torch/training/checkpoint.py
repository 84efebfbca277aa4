"""Checkpoints: atomic, asynchronous, keep-k (counterpart of
``repro.training.checkpoint``), in the reference's on-disk format.

* ``<dir>/step_<N:08d>/arrays.npz`` holds every leaf under the reference's
  flattened key (path parts joined by ``/``: dict keys, tuple indices,
  ``NamedTuple`` field names — ``0/embed``, ``1/m/blocks/attn/wq``,
  ``1/step``), and ``manifest.json`` the step, keys, shapes, dtypes and
  ``extra``.  A checkpoint either package writes, the other restores.
  bfloat16 leaves are written as float32 (exact; numpy has no bfloat16),
  their manifest dtype ``bfloat16``; the reference's bfloat16 arrays come
  back from numpy as raw 2-byte values and are read as bfloat16.
* **Atomic**: a save writes ``<dir>/tmp.<step>`` and renames it to
  ``step_<N>`` only when every file is on disk.
* **Async**: ``save`` copies the tensors to the host on the caller's
  thread (a copy even of a CPU tensor, which the next step updates in
  place) and writes them from a background thread.
* **Keep-k**: older checkpoints are removed after a successful save.
* **Placed state** (DTensor leaves, a run on a ``DeviceMesh``): ``save``
  gathers every leaf whole on every rank (a collective: every rank
  calls it), rank 0 writes the same files as an unplaced save, and the
  other ranks wait until they are published.  ``restore(..., mesh=,
  specs=)`` reads the whole arrays and places each leaf by its spec on
  ``mesh``, which may differ from the mesh the checkpoint was saved from
  (the reference's ``shardings=``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import PartitionSpec

Tree = Any

_SEP = "/"


def _items(tree: Tree, prefix: str = ""):
    """``(key, leaf)`` of every leaf, keys as the reference flattens them (a
    ``PartitionSpec``, though a tuple, is a leaf of a spec tree)."""
    if isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, PartitionSpec):
        children = [(str(i), x) for i, x in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for name, child in children:
        yield from _items(child, f"{prefix}{_SEP}{name}" if prefix else name)


def _rebuild(tree: Tree, leaf_fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaf_fn(key, leaf)``."""
    def key(name):
        return f"{prefix}{_SEP}{name}" if prefix else name

    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, key(str(k))) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn, key(f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaf_fn, key(str(i))) for i, x in enumerate(tree))
    return leaf_fn(prefix, tree)


def _is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array for the npz, and its manifest dtype: a copy,
    never a view of the leaf's storage (a DTensor's whole tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if _is_placed(x):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            return x.to("cpu", torch.float32, copy=True).numpy(), "bfloat16"
        arr = x.to("cpu", copy=True).numpy()
    else:
        arr = np.array(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, like) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype (``like`` a tensor)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # the reference's bfloat16
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Tree, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Write ``state`` (nested dicts, tuples, ``NamedTuple``s of tensors)
        as checkpoint ``step``: host copies now, files from a thread
        (``blocking`` waits for them).  With DTensor leaves every rank
        calls it: the leaves are gathered whole, rank 0 writes, and every
        rank returns once the files are published."""
        items = list(_items(state))
        placed = any(_is_placed(x) for _, x in items)
        host = {k: _to_host(x) for k, x in items}
        if placed:
            import torch.distributed as dist

            if dist.get_rank() == 0:
                self._write(step, host, extra)
            dist.barrier()
            return

        self.wait()
        t = threading.Thread(target=self._write, args=(step, host, extra), daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict, extra: Optional[dict]) -> None:
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = {k: arr for k, (arr, _) in host.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: dtype for k, (_, dtype) in host.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        with self._lock:
            steps = self.all_steps()
            for s in steps[: -self.keep] if self.keep > 0 else []:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                              ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Tree, step: Optional[int] = None, *, device=None, mesh=None,
                specs: Tree = None) -> tuple[int, Tree]:
        """``(step, tree)``: checkpoint ``step`` (default the latest) in the
        structure, shapes and dtypes of ``like`` (whole shapes: a DTensor's
        are), each leaf on ``device`` (default: ``like``'s leaf's device;
        ``meta`` leaves need one).  With a ``DeviceMesh`` ``mesh`` each
        leaf is read whole and placed on it by its ``PartitionSpec`` in
        ``specs`` (a tree like ``like``'s, e.g. ``(param_partition_specs,
        opt_state_partition_specs)``, whose AdamW moments and master carry
        their ZeRO split; default: every leaf whole on every rank), on
        ``mesh``'s device type; a 0-dim leaf (AdamW's step) comes back as
        a plain tensor, as ``cells.place_args`` leaves it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        arrays = np.load(os.path.join(path, "arrays.npz"))

        by_key = dict(_items(specs)) if specs is not None else {}

        def leaf(key, x):
            arr = arrays[key]
            assert arr.shape == tuple(x.shape), (key, arr.shape, tuple(x.shape))
            if mesh is None:
                return _from_host(arr, x).to(device if device is not None else x.device)
            from ..distributed.sharding import distribute_leaf, spec_placements

            t = _from_host(arr, x).to(mesh.device_type)
            if t.dim() == 0:        # a scalar (AdamW's step) stays whole, unplaced
                return t
            return distribute_leaf(t, spec_placements(by_key.get(key, PartitionSpec()), mesh),
                                   mesh)

        return step, _rebuild(like, leaf)
