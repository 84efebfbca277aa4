"""Data pipeline: a deterministic synthetic stream, packed token shards and
a prefetcher (counterpart of ``repro.training.data``).

Both sources are deterministic given ``(seed, step)`` — a restarted job
resumes mid-epoch from the checkpoint's step counter alone — and split by
``(dp_rank, dp_world)`` so each data-parallel worker reads its own slice.
They build numpy batches exactly as the reference's do (the same
``np.random.default_rng`` seeding), so ``batch_at(step)`` is bit-equal to
the reference's.  :class:`Prefetcher` stages batches onto the device from
a thread, overlapping input with compute.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch


class SyntheticStream:
    """Deterministic pseudo-text: Zipfian tokens from a counter-seeded
    generator."""

    def __init__(self, vocab_size: int, batch_size: int, seq_len: int, seed: int = 0,
                 dp_rank: int = 0, dp_world: int = 1):
        assert batch_size % dp_world == 0
        self.vocab_size = vocab_size
        self.local_batch = batch_size // dp_world
        self.seq_len = seq_len
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        # Zipf-ish distribution over the vocab (a heavier head, like text).
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 65_537 + self.dp_rank)
        tokens = rng.choice(self.vocab_size, size=(self.local_batch, self.seq_len),
                            p=self._probs).astype(np.int32)
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_token_shards(path: str, num_shards: int, tokens_per_shard: int, vocab_size: int,
                       seed: int = 0) -> None:
    """Write packed token shards (one flat ``.npy`` per shard) and a
    manifest."""
    os.makedirs(path, exist_ok=True)
    for i in range(num_shards):
        rng = np.random.default_rng(seed * 7919 + i)
        arr = rng.integers(0, vocab_size, size=(tokens_per_shard,), dtype=np.int32)
        np.save(os.path.join(path, f"shard_{i:05d}.npy"), arr)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"num_shards": num_shards, "tokens_per_shard": tokens_per_shard,
                   "vocab_size": vocab_size}, f)


class PackedShards:
    """Memory-mapped packed sequences with deterministic addressing:
    ``batch_at(step)`` computes each row's shard and offset from the step
    and rank, so there is no iterator state to checkpoint."""

    def __init__(self, path: str, batch_size: int, seq_len: int, dp_rank: int = 0,
                 dp_world: int = 1):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        assert batch_size % dp_world == 0
        self.path = path
        self.local_batch = batch_size // dp_world
        self.global_batch = batch_size
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        self._mmaps = [np.load(os.path.join(path, f"shard_{i:05d}.npy"), mmap_mode="r")
                       for i in range(self.manifest["num_shards"])]
        self.windows_per_shard = self.manifest["tokens_per_shard"] // seq_len
        self.total_windows = self.windows_per_shard * self.manifest["num_shards"]

    def batch_at(self, step: int) -> dict:
        out = np.empty((self.local_batch, self.seq_len), np.int32)
        base = step * self.global_batch + self.dp_rank * self.local_batch
        for j in range(self.local_batch):
            w = (base + j) % self.total_windows
            shard, idx = divmod(w, self.windows_per_shard)
            off = idx * self.seq_len
            out[j] = self._mmaps[shard][off:off + self.seq_len]
        return {"tokens": out}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (integer arrays as int64)."""
    out = {}
    for key, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[key] = t.to(device)
    return out


class Prefetcher:
    """Stages ``source.batch_at(step)`` for ``step = start_step, ...`` onto
    ``device`` from a thread, ``depth`` batches ahead; ``next()`` returns
    ``(step, batch)``.  ``close()`` stops the thread.

    With a ``DeviceMesh`` ``mesh`` instead of ``device`` (the reference's
    ``sharding=``), each batch comes out placed: every leaf a DTensor of
    this rank's block, split by :func:`~repro_torch.distributed.sharding.
    batch_spec` or by ``specs`` (one ``PartitionSpec`` for every leaf, or
    a dict of them by key).  ``source`` gives every rank the whole batch,
    so no rank sends anything."""

    def __init__(self, source, start_step: int = 0, depth: int = 2, *, device=None,
                 mesh=None, specs=None):
        if (device is None) == (mesh is None):
            raise TypeError("Prefetcher takes one of device= and mesh=: it has no default "
                            "device")
        self.source = source
        self.device = torch.device(device if mesh is None else mesh.device_type)
        self.mesh, self.specs = mesh, specs
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        from ..distributed.sharding import (PartitionSpec, batch_spec, distribute_leaf,
                                            spec_placements)

        def spec(key):
            if self.specs is None:
                return batch_spec(self.mesh)
            return self.specs if isinstance(self.specs, PartitionSpec) else self.specs[key]

        return {k: distribute_leaf(x, spec_placements(spec(k), self.mesh), self.mesh)
                for k, x in batch.items()}

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = to_device(self.source.batch_at(step), self.device)
            item = (step, batch if self.mesh is None else self._place(batch))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join()
