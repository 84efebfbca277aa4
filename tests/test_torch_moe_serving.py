"""``SearchService`` over the port's MoE family against the JAX package.

The reference's reduced qwen2-moe-a2.7b (4 experts, top 2, shared experts,
float32; parameters carried across with ``params_from_numpy``) behind
``SearchService`` in phase 7's serving form at a tiny size: 6 ragged
prompts through B = 2 rows, async wu_uct, T = 6.  Fused and host-paced,
dense and paged, each path's results equal the reference's same path:
action, root visit counts and ticks exact, root values within 1e-6
(relative, atol 1e-6).

At the default capacity factor the two paths differ from each other, in
the reference as here: an idle row's tokens route with the live rows' and
can take an expert's last places, and the two paths leave different
tokens in idle rows.  With room for every token (``capacity_factor=8.0``)
a token's routing no longer depends on the others, and fused equals
host-paced (root values within 1e-6 absolute, the bar of
``tests/test_torch_ring.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import SearchSpec as JaxSearchSpec
from repro.models import init_params as jax_init_params
from repro.serving import SearchService as JaxSearchService
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import SearchSpec
from repro_torch.serving import SearchService

torch.set_num_threads(2)

VALUE_TOL = dict(rtol=1e-6, atol=1e-6)
MOE = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module")
def moe_lm():
    jcfg = jax_get_reduced(MOE)
    cfg = get_reduced(MOE)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                    device="cpu")


PROMPTS = [[3, 5], [2, 9, 4], [7], [1, 2, 3], [5, 5], [6]]


def _keys(seed, n):
    return [np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), i)) for i in range(n)]


def _service_rows(cfg, params, search_cls, paged, **kw):
    spec = search_cls[1](batch=2, algo="wu_uct", engine="async", num_simulations=6,
                         wave_size=2, max_depth=3, max_sim_steps=3, max_width=4, gamma=1.0)
    return search_cls[0](cfg, params, spec, top_k=4, max_len=12, eos_token=1, block_size=4,
                         ticks_per_round=4, paged=paged, **kw).serve(
        PROMPTS, keys=_keys(11, len(PROMPTS)))


def _rows_equal(got, want, **value_tol):
    assert len(got) == len(want) == len(PROMPTS)
    for a, b in zip(got, want):
        assert int(a.action) == int(b.action) and int(a.ticks) == int(b.ticks)
        np.testing.assert_array_equal(np.asarray(a.root_n), np.asarray(b.root_n))
        np.testing.assert_allclose(np.asarray(a.root_v), np.asarray(b.root_v), **value_tol)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_search_service_equals_reference(moe_lm, paged):
    """Fused and host-paced ``SearchService`` each equal the reference's.

    At the default capacity factor the two paths differ from each other,
    in the reference as here: an idle row's tokens route with the live
    rows' and can take an expert's last places, and the two paths leave
    different tokens in idle rows.  With room for every token
    (``capacity_factor=8.0``; checked dense) the routing of a token no
    longer depends on the others, and fused equals host-paced."""
    jcfg, jp, cfg, p = moe_lm
    port, ref = (SearchService, SearchSpec), (JaxSearchService, JaxSearchSpec)
    for fused in (True, False):
        _rows_equal(_service_rows(cfg, p, port, paged, fused=fused, device="cpu"),
                    _service_rows(jcfg, jp, ref, paged, fused=fused), **VALUE_TOL)
    if paged:
        return
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    _rows_equal(_service_rows(roomy, p, port, paged, device="cpu"),
                _service_rows(roomy, p, port, paged, fused=False, device="cpu"),
                rtol=0, atol=1e-6)
