"""The port's sharding rules against the reference's, spec for spec, on
abstract meshes (names and sizes, no devices on either side).

Specs are compared with every entry normalised to a tuple of axis names
(``None`` -> ``()``, ``'data'`` -> ``('data',)``) and padded to the leaf's
rank, so a bare name and a one-name tuple, and ``P()`` and ``P(None,
None)``, compare equal on both sides.
"""

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as ref
from repro.models import abstract_params as jax_abstract_params
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding
from repro_torch.models import abstract_params
from repro_torch.training.optimizer import leaves

MESHES = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "test": ((2, 4), ("data", "model")),
    "test_multi": ((2, 2, 2), ("pod", "data", "model")),
    "single_device": ((1, 1), ("data", "model")),
}


def _norm(spec, ndim=None):
    entries = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    if ndim is not None:
        entries += [()] * (ndim - len(entries))
    return tuple(entries)


def _meshes(name):
    sizes, names = MESHES[name]
    return ref.abstract_mesh(sizes, names), sharding.abstract_mesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return jax_abstract_params(jax_get_config(arch)), abstract_params(get_config(arch))


def _pairs(arch, mesh_name, strategy):
    jmesh, tmesh = _meshes(mesh_name)
    jparams, tparams = _abstract(arch)
    jspecs = jax.tree.leaves(ref.param_partition_specs(jax_get_config(arch), jparams, jmesh,
                                                       strategy),
                             is_leaf=lambda x: isinstance(x, JP))
    tspecs = leaves(sharding.param_partition_specs(get_config(arch), tparams, tmesh, strategy))
    shapes = [tuple(x.shape) for x in jax.tree.leaves(jparams)]
    assert [tuple(x.shape) for x in leaves(tparams)] == shapes
    assert len(jspecs) == len(tspecs) == len(shapes)
    return jmesh, tmesh, list(zip(shapes, jspecs, tspecs))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, strategy, mesh_name):
    _, _, pairs = _pairs(arch, mesh_name, strategy)
    for shape, js, ts in pairs:
        assert isinstance(ts, sharding.PartitionSpec)
        assert _norm(ts, len(shape)) == _norm(js, len(shape)), (shape, js, ts)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_zero_shard_matches_the_reference(strategy, mesh_name):
    """The optimizer state's ZeRO split of every leaf of every arch."""
    for arch in list_archs():
        jmesh, tmesh, pairs = _pairs(arch, mesh_name, strategy)
        for shape, js, ts in pairs:
            got = sharding._zero_shard(ts, shape, tmesh)
            want = ref._zero_shard(js, shape, jmesh)
            assert _norm(got, len(shape)) == _norm(want, len(shape)), (arch, shape, js)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_opt_state_specs_are_the_zero_split(mesh_name):
    arch = "llama3-8b"
    jmesh, tmesh, pairs = _pairs(arch, mesh_name, "tp")
    specs = sharding.opt_state_partition_specs(get_config(arch), _abstract(arch)[1], tmesh)
    assert specs.step == sharding.P()
    for moment in (specs.m, specs.v, specs.master):
        for (shape, js, _), got in zip(pairs, leaves(moment)):
            assert _norm(got, len(shape)) == _norm(ref._zero_shard(js, shape, jmesh),
                                                   len(shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("global_batch", [1, 32, 256])
def test_batch_spec_matches_the_reference(global_batch, strategy, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    assert _norm(sharding.batch_spec(tmesh, strategy, global_batch)) == _norm(
        ref.batch_spec(jmesh, strategy, global_batch))


@pytest.mark.parametrize("shape,want", [
    ((4096, 14336), (None, ("data", "model"))),
    ((151936, 4096), (None, ("data", "model"))),
    ((7, 13), ()),
])
def test_fsdp_rule_cases(shape, want):
    """``tests/test_sharding_rules.py``'s cases, on both packages."""
    tmesh = sharding.abstract_mesh((16, 16), ("data", "model"))
    jmesh = ref.abstract_mesh((16, 16), ("data", "model"))
    got = sharding._fsdp_rule(shape, tmesh, ("data", "model"))
    assert got == sharding.P(*want)
    assert _norm(got, len(shape)) == _norm(ref._fsdp_rule(shape, jmesh, ("data", "model")),
                                           len(shape))


@pytest.mark.parametrize("axes", [
    (("pod", "data"), "model", None),
    (("pod", "data"), None),
    ("pod", "data"),
    (("pod",), "model"),
    (None, None),
])
@pytest.mark.parametrize("mesh_name", ["single_pod", "multi_pod"])
def test_logical_spec_drops_absent_axes(axes, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    assert _norm(sharding.logical_spec(tmesh, *axes)) == _norm(ref.logical_spec(jmesh, *axes))


def test_data_axes_and_tp_rule():
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        assert sharding.data_axes(tmesh) == ref.data_axes(jmesh)
        for dim in (8, 12, 40, 64):
            assert sharding._tp_ok(dim, tmesh) == ref._tp_ok(dim, jmesh)


def test_placements_split_major_to_minor():
    """A tuple entry ``('data', 'model')`` splits its dim with ``data``
    major, as JAX does: on a live one-rank mesh the placements put
    ``Shard`` on both mesh dims (DTensor's default order, mesh dim 0
    first), and a tuple out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    tmesh = sharding.abstract_mesh((2, 4), ("data", "model"))

    class Live:  # the two attributes spec_placements reads
        mesh_dim_names = tmesh.axis_names

    assert sharding.spec_placements(sharding.P(None, ("data", "model")), Live()) == (
        Shard(1), Shard(1))
    assert sharding.spec_placements(sharding.P("model", None), Live()) == (Replicate(),
                                                                            Shard(0))
    with pytest.raises(ValueError):
        sharding.spec_placements(sharding.P(("model", "data")), Live())
