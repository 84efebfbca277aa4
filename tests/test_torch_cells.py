"""The port's cells and dry run against the reference's.

The reference's ``build_cell`` needs a concrete mesh, so one subprocess
with 8 forced host devices builds its cells and dumps what is compared to
JSON: the cell list with skip reasons, ``model_flops`` of every runnable
cell on the test mesh, and for ``tests/test_dryrun_small.py``'s four cells
the arguments' shapes and dtypes and their specs (normalised: every entry
a tuple of axis names, padded to the leaf's rank).
"""

import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.launch import dryrun
from repro_torch.launch.cells import SHAPES, all_cells, build_cell, skip_reason
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("llama3-8b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
         ("mamba2-2.7b", "long_500k"), ("whisper-small", "prefill_32k")]

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys, types
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.cells import SHAPES, _pad_experts, all_cells, build_cell
from repro.launch.dryrun import model_flops
from repro.launch.mesh import make_test_mesh

CELLS = json.loads(sys.argv[1])
mesh = make_test_mesh()
tp = dict(zip(mesh.axis_names, mesh.devices.shape))["model"]


def norm(spec, ndim):
    entries = [[] if e is None else [e] if isinstance(e, str) else list(e) for e in spec]
    return entries + [[]] * (ndim - len(entries))


def flat(args, shardings):
    out = []
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    specs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(leaves, specs):
        key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                       for p in path)
        out.append([key, list(leaf.shape), str(leaf.dtype), norm(sh.spec, len(leaf.shape))])
    return out


res = {"all_cells": all_cells(), "flops": {}, "cells": {}}
for arch, shape, reason in all_cells():
    if reason is None:
        spec = SHAPES[shape]
        tokens = spec["global_batch"] * (spec["seq_len"] if spec["kind"] != "decode" else 1)
        cell = types.SimpleNamespace(kind=spec["kind"], tokens_per_step=tokens,
                                     model_cfg=_pad_experts(get_config(arch), tp))
        res["flops"][f"{arch}/{shape}"] = model_flops(cell, 8)
for arch, shape in CELLS:
    cell = build_cell(arch, shape, mesh)
    res["cells"][f"{arch}/{shape}"] = {
        "kind": cell.kind, "tokens": cell.tokens_per_step,
        "args": [flat(a, s) for a, s in zip(cell.arg_specs, cell.in_shardings)]}
print("RESULTS:" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(CELLS)],
                          capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULTS:")][0]
    return json.loads(line[len("RESULTS:"):])


def _norm(spec, ndim):
    entries = [[] if e is None else [e] if isinstance(e, str) else list(e) for e in spec]
    return entries + [[]] * (ndim - len(entries))


def _flat(args, specs, prefix=""):
    """``[path, shape, dtype, spec]`` in the reference's leaf order."""
    if isinstance(args, dict):
        return [x for k in sorted(args) for x in _flat(args[k], specs[k], f"{prefix}{k}/")]
    if isinstance(args, tuple):   # AdamWState: fields in order
        return [x for name, a, s in zip(args._fields, args, specs)
                for x in _flat(a, s, f"{prefix}{name}/")]
    assert isinstance(specs, PartitionSpec)
    return [[prefix[:-1], list(args.shape), str(args.dtype).replace("torch.", ""),
             _norm(specs, args.dim())]]


def test_all_cells_and_skip_reasons(reference):
    assert [list(c) for c in all_cells()] == reference["all_cells"]
    for arch, shape, reason in all_cells():
        assert skip_reason(arch, shape) == reason


def test_model_flops_match_the_reference(reference):
    mesh = make_test_mesh()
    runnable = [(a, s) for a, s, r in all_cells() if r is None]
    assert len(runnable) == len(reference["flops"])
    for arch, shape in runnable:
        cell = build_cell(arch, shape, mesh)
        assert dryrun.model_flops(cell, 8) == reference["flops"][f"{arch}/{shape}"], (arch,
                                                                                     shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_arguments_and_specs_match_the_reference(reference, arch, shape):
    want = reference["cells"][f"{arch}/{shape}"]
    cell = build_cell(arch, shape, make_test_mesh())
    assert cell.kind == want["kind"]
    assert cell.tokens_per_step == want["tokens"]
    got = [_flat(a, s) for a, s in zip(cell.arg_specs, cell.in_shardings)]
    for g, w in zip(got, want["args"]):
        # Leaf names differ only in how each side spells a path; the order,
        # shapes, dtypes and specs must not.
        assert [x[1:] for x in g] == [x[1:] for x in w]
        assert [x[0].split("/")[-1] for x in g] == [x[0].split("/")[-1] for x in w]


@pytest.mark.parametrize("mesh_name", ["single_pod", "multi_pod"])
def test_per_rank_bytes_add_up(mesh_name):
    """Every rank's bytes times the ranks are the unsharded totals, each
    leaf counted as many times as it is replicated."""
    mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod")
    ranks = math.prod(mesh.shape.values())
    for arch, shape, reason in all_cells():
        if reason is not None:
            continue
        rec = dryrun.run_cell(arch, shape, mesh, mesh_name)
        cell = build_cell(arch, shape, mesh)
        for name, args, specs in zip(rec["per_rank_bytes"], cell.arg_specs, cell.in_shardings):
            leaves = _flat(args, specs)
            replicated = 0
            for _, shp, dtype, spec in leaves:
                parts = math.prod(mesh.shape[a] for entry in spec for a in entry)
                replicated += ranks // parts * _bytes(shp, dtype)
            assert rec["per_rank_bytes"][name] * ranks == replicated, (arch, shape, name)
            assert rec["total_bytes"][name] == sum(_bytes(s, d) for _, s, d, _ in leaves)
        assert rec["model_flops"] == dryrun.model_flops(cell, ranks)


def _bytes(shape, dtype):
    size = {"float32": 4, "bfloat16": 2, "int32": 4, "int64": 8}[dtype]
    return math.prod(shape) * size


def test_dryrun_cli_reports_skips(capsys):
    recs = dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k"])
    assert recs[0]["skipped"] == skip_reason("llama3-8b", "long_500k")
    recs = dryrun.main(["--arch", "mamba2-2.7b", "--shape", "train_4k", "--mesh", "test"])
    assert recs[0]["per_rank_bytes"]["params"] > 0
    assert "long_500k" in SHAPES
