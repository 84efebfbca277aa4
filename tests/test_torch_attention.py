"""The port's attention kernels' plain versions against the JAX package.

The plain versions (what the port's wrappers run on CPU tensors:
``decode_attention_ref``, ``flash_attention_ref`` and the paged and tree
decode versions) are held against the JAX Pallas kernels in interpret mode
and against the XLA oracles of ``repro.models.layers``, float32 at tiny
shapes, with ragged ``kv_len`` including 0.  Tolerance: atol = rtol =
1e-5, for summation order (the Pallas kernels sum keys block by block, the
oracles and the port in one einsum).  The XLA oracles give a query with
nothing to attend (``kv_len = 0`` and no tail entry) the mean of V (a
softmax over all-masked scores is uniform) where the Pallas kernels and
the port give zeros, so such rows are compared with the kernels only.
Page tables carry the sentinel ``P`` and stale ids past each row's live
pages, and pages shared by several rows.

On a CUDA machine the hand-written kernels are held against their plain
versions (``pytest -m cuda``); those tests import no JAX.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    decode_attention_split,
    decode_parts,
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_tree_decode_attention,
    paged_tree_decode_attention_ref,
    tree_decode_attention,
    tree_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models import layers

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
LAYOUTS = [(4, 2), (4, 1), (2, 2)]     # (Hq, Hkv)


def _arrays(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("hq,hkv", LAYOUTS)
def test_decode_ref_matches_pallas_kernel_and_oracle(hq, hkv):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import decode_attention as jax_kernel
    from repro.models.layers import decode_attention as jax_oracle

    n, s, d = 6, 16, 16
    q, k, v = _arrays(hq, (n, hq, d), (n, s, hkv, d), (n, s, hkv, d))
    lens = np.array([0, 1, 16, 7, 9, 3], np.int32)
    out = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(lens))
    assert out.dtype == torch.float32 and out.shape == (n, hq, d)
    kern = np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens), block_k=8))
    np.testing.assert_allclose(out.numpy(), kern, **TOL)
    np.testing.assert_array_equal(out.numpy()[0], 0.0)          # kv_len = 0
    oracle = np.asarray(jax_oracle(jnp.asarray(q)[:, None], jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lens)))[:, 0]
    np.testing.assert_allclose(out.numpy()[1:], oracle[1:], **TOL)
    # The port's copy of the oracle is the oracle.
    port_oracle = layers.decode_attention(torch.from_numpy(q)[:, None], torch.from_numpy(k),
                                          torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(port_oracle.numpy()[:, 0], oracle, **TOL)


def test_decode_ref_scalar_len_broadcasts():
    q, k, v = (torch.from_numpy(x) for x in _arrays(1, (3, 4, 16), (3, 8, 2, 16),
                                                      (3, 8, 2, 16)))
    by_row = decode_attention(q, k, v, torch.tensor([5, 5, 5], dtype=torch.int32))
    for scalar in (5, torch.tensor(5)):
        torch.testing.assert_close(decode_attention(q, k, v, scalar), by_row, rtol=0, atol=0)


def test_decode_ref_is_softmax_attention_over_the_valid_prefix():
    """Direct check of the definition on one row, in float64."""
    q, k, v = _arrays(2, (1, 4, 16), (1, 10, 2, 16), (1, 10, 2, 16))
    out = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), 6).numpy()
    for h in range(4):
        kv = h // 2
        s = (k[0, :6, kv].astype(np.float64) @ q[0, h]) / math.sqrt(16)
        p = np.exp(s - s.max())
        want = (p / p.sum()) @ v[0, :6, kv]
        np.testing.assert_allclose(out[0, h], want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("hq,hkv", LAYOUTS)
@pytest.mark.parametrize("b,s", [(1, 1), (2, 8), (1, 16)])
def test_flash_ref_matches_pallas_kernel_and_oracles(hq, hkv, b, s):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as jax_kernel
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref
    from repro.models.layers import chunked_attention as jax_chunked

    d = 16
    q, k, v = _arrays(10 * b + s, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (b, s, hq, d)
    blk = min(8, s)
    args = [jnp.asarray(x) for x in (q, k, v)]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_kernel(*args, block_q=blk,
                                                                  block_k=blk)), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(*args)), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_chunked(*args, chunk=4)), **TOL)


def test_flash_ref_non_causal_matches_pallas_kernel():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as jax_kernel

    q, k, v = _arrays(3, (2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    ref = jax_kernel(*(jnp.asarray(x) for x in (q, k, v)), causal=False, block_q=4, block_k=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _paged_case(seed, b, bs, n_pages, hq, hkv, d=16):
    """Pools, a page table and ragged lengths: rows share pages, entries
    past each row's live pages hold the sentinel P or stale ids."""
    rs = np.random.default_rng(seed)
    p = b * n_pages
    q, pk, pv = _arrays(seed, (b, hq, d), (p, bs, hkv, d), (p, bs, hkv, d))
    table = rs.permutation(p)[: b * n_pages].reshape(b, n_pages).astype(np.int32)
    full = n_pages * bs
    lens = np.array([0, full, min(full, bs + 1), max(1, full - bs // 2)]
                    + [int(x) for x in rs.integers(0, full + 1, size=b - 4)], np.int32)
    for r in range(b):
        live = -(-int(lens[r]) // bs)
        table[r, live:] = np.where(np.arange(n_pages - live) % 2, p, table[0, 0])
    if b > 2 and lens[2] > 0:
        table[2, 0] = table[1, 0]                  # a page shared by two rows
    return q, pk, pv, table, lens


PAGED_CASES = [(1, 3), (3, 2), (4, 4), (16, 2)]       # (block size, pages)


@pytest.mark.parametrize("bs,n_pages", PAGED_CASES)
def test_paged_decode_ref_matches_pallas_kernel_and_oracle(bs, n_pages):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import paged_decode_attention as jax_kernel
    from repro.models.layers import paged_decode_attention as jax_oracle

    q, pk, pv, table, lens = _paged_case(bs, 6, bs, n_pages, 4, 2)
    out = paged_decode_attention(*(torch.from_numpy(x) for x in (q, pk, pv, table, lens)))
    assert out.shape == q.shape
    args = [jnp.asarray(x) for x in (q, pk, pv, table, lens)]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_kernel(*args)), **TOL)
    np.testing.assert_array_equal(out.numpy()[0], 0.0)          # kv_len = 0
    oracle = np.asarray(jax_oracle(args[0][:, None], *args[1:]))[:, 0]
    np.testing.assert_allclose(out.numpy()[1:], oracle[1:], **TOL)
    # The same pages read densely give the dense decode's answer.
    gathered = [torch.from_numpy(x[np.clip(table, 0, x.shape[0] - 1)].reshape(
        table.shape[0], -1, 2, 16)) for x in (pk, pv)]
    torch.testing.assert_close(out, decode_attention(torch.from_numpy(q), *gathered,
                                                     torch.from_numpy(lens)), rtol=0, atol=0)


TREE_MASKS = ["identity", "lower", "none"]


def _tree_mask(name, a):
    if name == "identity":
        return None
    if name == "lower":
        return np.tril(np.ones((a, a), bool))
    return np.zeros((a, a), bool)                   # no tail entry at all


@pytest.mark.parametrize("a", [1, 4])
@pytest.mark.parametrize("mask", TREE_MASKS)
def test_tree_decode_ref_matches_pallas_kernel_and_oracle(a, mask):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import tree_decode_attention as jax_kernel
    from repro.models.layers import tree_decode_attention as jax_oracle

    b, s, hq, hkv, d = 5, 12, 4, 2, 16
    q, kc, vc, ks, vs = _arrays(a, (b, a, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                                (b, a, hkv, d), (b, a, hkv, d))
    lens = np.array([0, 1, 12, 7, 5], np.int32)
    m = _tree_mask(mask, a)
    out = tree_decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, ks, vs, lens)),
                                None if m is None else torch.from_numpy(m))
    assert out.shape == q.shape
    args = [jnp.asarray(x) for x in (q, kc, vc, ks, vs, lens)]
    jm = None if m is None else jnp.asarray(m)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_kernel(*args, jm, block_k=4)),
                               **TOL)
    rows = slice(1, None) if mask == "none" else slice(None)   # row 0: nothing to attend
    if mask == "none":
        np.testing.assert_array_equal(out.numpy()[0], 0.0)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jax_oracle(*args, jm))[rows],
                               **TOL)


@pytest.mark.parametrize("bs,n_pages,mask", [case + (mask,) for case, mask in
                                              zip(PAGED_CASES, ["identity", "lower"] * 2)])
def test_paged_tree_decode_ref_matches_pallas_kernel_and_oracle(bs, n_pages, mask):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import (
        paged_tree_decode_attention as jax_kernel,
    )
    from repro.models.layers import paged_tree_decode_attention as jax_oracle

    a, hq, hkv, d = 3, 4, 2, 16
    _, pk, pv, table, lens = _paged_case(10 + bs, 6, bs, n_pages, hq, hkv)
    q, ks, vs = _arrays(bs, (6, a, hq, d), (6, a, hkv, d), (6, a, hkv, d))
    m = _tree_mask(mask, a)
    tm = None if m is None else torch.from_numpy(m)
    out = paged_tree_decode_attention(
        *(torch.from_numpy(x) for x in (q, pk, pv, table, ks, vs, lens)), tm)
    args = [jnp.asarray(x) for x in (q, pk, pv, table, ks, vs, lens)]
    jm = None if m is None else jnp.asarray(m)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_kernel(*args, jm)), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_oracle(*args, jm)), **TOL)
    # The paged prefix read through the table is the dense tree decode of
    # the gathered pages.
    gathered = [torch.from_numpy(x[np.clip(table, 0, x.shape[0] - 1)].reshape(
        table.shape[0], -1, hkv, d)) for x in (pk, pv)]
    dense = tree_decode_attention(torch.from_numpy(q), *gathered, torch.from_numpy(ks),
                                  torch.from_numpy(vs), torch.from_numpy(lens), tm)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)


def test_tree_decode_ref_is_one_softmax_over_prefix_and_tail():
    """Direct check of the definition on one row, in float64: candidate
    ``a`` sees the valid prefix and the tail entries its mask row allows."""
    a, s, hq, hkv, d = 3, 6, 4, 2, 16
    q, kc, vc, ks, vs = _arrays(5, (1, a, hq, d), (1, s, hkv, d), (1, s, hkv, d),
                                (1, a, hkv, d), (1, a, hkv, d))
    mask = np.tril(np.ones((a, a), bool))
    out = tree_decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, ks, vs)), 4,
                                torch.from_numpy(mask)).numpy()
    for c in range(a):
        for h in range(hq):
            kv = h // 2
            keys = np.concatenate([kc[0, :4, kv], ks[0, mask[c], kv]]).astype(np.float64)
            vals = np.concatenate([vc[0, :4, kv], vs[0, mask[c], kv]]).astype(np.float64)
            sc = keys @ q[0, c, h] / math.sqrt(d)
            p = np.exp(sc - sc.max())
            np.testing.assert_allclose(out[0, c, h], (p / p.sum()) @ vals, atol=1e-6,
                                       rtol=1e-5)


def test_wrappers_reject_other_devices():
    q = torch.zeros(2, 4, 16, device="meta")
    kv = torch.zeros(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_attention(q, kv, kv, 3)
    q4 = torch.zeros(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q4, kv, kv)
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        paged_decode_attention(q, kv, kv, table, 3)
    spec = torch.zeros(2, 8, 2, 16, device="meta")
    for fn, prefix in ((tree_decode_attention, (kv, kv)),
                       (paged_tree_decode_attention, (kv, kv, table))):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(q4, *prefix, spec, spec, 3)


# ---------------------------------------------------------------------------
# On the card: kernel against plain version.
# ---------------------------------------------------------------------------

# float32: the kernel sums the D products and the keys in another order
# than cuBLAS (errors ~1e-6 of |V|).  bfloat16: both compute in float32
# and round the output once, so they differ by at most one bf16 ulp
# (2^-8 relative, 2^-7 taken for margin).
CUDA_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5),
            torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


def _cuda_inputs(gen, dtype, *shapes):
    return [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in shapes]


# kv_len at 0, 1, around one warp step of keys (8 at bf16 D=128: 4 warps
# x 2 keys) and past it, 33, and S: some warps see no key at all.
DECODE_LENS = (0, 1, 7, 8, 9, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 1, 32, 8, 128), (128, 160, 32, 8, 128), (33, 100, 4, 1, 64),
             (5, 40, 8, 8, 16)]
    cases += [(len(DECODE_LENS) + 3, s, hq, hkv, d) for s in (40, 160)
              for hq, hkv in ((32, 8), (8, 8), (32, 32), (4, 1), (12, 1))
              for d in (16, 64, 112, 128)]
    if dtype == torch.float32:
        cases += [(9, 70, 8, 2, 256), (9, 70, 4, 4, 132)]   # two 16-byte chunks per lane
    for n, s, hq, hkv, d in cases:
        q, k, v = _cuda_inputs(gen, dtype, (n, hq, d), (n, s, hkv, d), (n, s, hkv, d))
        lens = torch.randint(0, s + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        lens[0] = 0
        if n > len(DECODE_LENS):
            lens[:len(DECODE_LENS) + 1] = torch.tensor([*DECODE_LENS, s], dtype=torch.int32)
        before = LAUNCHES["decode_attention"]
        out = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(out, decode_attention_ref(q, k, v, lens), **CUDA_TOL[dtype],
                                   msg=lambda m: f"N={n} S={s} {hq}/{hkv} D={d}: {m}")
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(1, 1, 32, 8, 128, True), (8, 160, 32, 8, 128, True), (1, 7, 4, 1, 64, True),
             (2, 70, 8, 8, 16, True), (8, 160, 32, 32, 112, True)]
    # Around the 16-row warp slices and the 64-query / 64-key tiles.
    cases += [(2, s, hq, hkv, d, causal) for s in (1, 15, 16, 17, 63, 64, 65, 160)
              for hq, hkv in ((32, 8), (8, 8), (32, 32), (4, 1))
              for d in (16, 64, 112, 128) for causal in (True, False)]
    for b, s, hq, hkv, d, causal in cases:
        q, k, v = _cuda_inputs(gen, dtype, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
        before = LAUNCHES["flash_attention"]
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + 1
        torch.testing.assert_close(
            out, flash_attention_ref(q, k, v, causal=causal), **CUDA_TOL[dtype],
            msg=lambda m: f"B={b} S={s} {hq}/{hkv} D={d} causal={causal}: {m}")


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(2, 8, 4, 16, device="cuda")
    kv = torch.zeros(2, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.zeros(2, 8, 4, 24, device="cuda"),
                        torch.zeros(2, 8, 2, 24, device="cuda"),
                        torch.zeros(2, 8, 2, 24, device="cuda"))
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q[:, 0].contiguous(), kv, kv, torch.tensor([1, 2, 3], device="cuda"))
    # The 16-byte loads: data_ptr() 16-byte aligned, decode D a multiple of
    # 16 bytes' worth of elements.
    off = torch.zeros(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(off, kv, kv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, kv, torch.zeros(kv.numel() + 2, device="cuda")[2:].view(kv.shape))
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(torch.zeros(2 * 4 * 16 + 1, device="cuda")[1:].view(2, 4, 16),
                         kv, kv, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q[:, 0].contiguous(),
                         torch.zeros(kv.numel() + 1, device="cuda")[1:].view(kv.shape), kv, 3)
    for dtype, d in ((torch.bfloat16, 12), (torch.float32, 6), (torch.float32, 260)):
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(torch.zeros(2, 4, d, dtype=dtype, device="cuda"),
                             torch.zeros(2, 8, 2, d, dtype=dtype, device="cuda"),
                             torch.zeros(2, 8, 2, d, dtype=dtype, device="cuda"), 3)
    # The paged kernel runs the same key-split body.
    pool12 = torch.zeros(6, 4, 2, 12, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(torch.zeros(2, 4, 12, dtype=torch.bfloat16, device="cuda"),
                               pool12, pool12, torch.zeros(2, 3, dtype=torch.int32,
                                                           device="cuda"), 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(q[:, 0].contiguous(),
                               torch.zeros(6 * 4 * 2 * 16 + 1, device="cuda")[1:].view(6, 4, 2, 16),
                               torch.zeros(6, 4, 2, 16, device="cuda"),
                               torch.zeros(2, 3, dtype=torch.int32, device="cuda"), 3)
    pool = torch.zeros(6, 4, 2, 16, device="cuda")
    table = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page_table"):
        paged_decode_attention(q[:, 0].contiguous(), pool, pool, table[:1], 3)
    spec = torch.zeros(2, 33, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="at most 32"):
        tree_decode_attention(torch.zeros(2, 33, 4, 16, device="cuda"), kv, kv, spec, spec, 3)
    spec8 = torch.zeros(2, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="tree_mask"):
        paged_tree_decode_attention(q, pool, pool, table, spec8, spec8, 3,
                                    torch.ones(4, 4, device="cuda"))


def _cuda_paged_case(gen, dtype, b, bs, n_pages, hq, hkv, d, a=0):
    """CUDA inputs: pools of b * n_pages blocks, a shuffled table whose
    entries past each row's live pages are the sentinel or stale ids, a
    page shared by rows 1 and 2, and lengths covering 0, a full row and a
    length ending mid-page."""
    p = b * n_pages
    q_shape = (b, a, hq, d) if a else (b, hq, d)
    q, pk, pv = _cuda_inputs(gen, dtype, q_shape, (p, bs, hkv, d), (p, bs, hkv, d))
    table = torch.randperm(p, generator=gen, device="cuda")[: b * n_pages].reshape(
        b, n_pages).to(torch.int32)
    full = n_pages * bs
    lens = torch.randint(0, full + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    lens[:3] = torch.tensor([0, full, max(1, full - bs // 2)], dtype=torch.int32)
    pages = torch.arange(n_pages, device="cuda")[None, :]
    dead = pages >= ((lens + bs - 1) // bs)[:, None]
    stale = torch.where(pages % 2 == 0, p, table[0, 0])
    table = torch.where(dead, stale.to(torch.int32), table)
    if b > 2:
        table[2, 0] = table[1, 0]
    spec = _cuda_inputs(gen, dtype, (b, a, hkv, d), (b, a, hkv, d)) if a else ()
    return q, pk, pv, table, lens, spec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, bs, n_pages, hq, hkv, d in [(128, 16, 10, 32, 8, 128), (7, 1, 5, 4, 2, 16),
                                       (9, 3, 4, 8, 8, 64), (5, 4, 3, 4, 1, 64)]:
        q, pk, pv, table, lens, _ = _cuda_paged_case(gen, dtype, b, bs, n_pages, hq, hkv, d)
        before = LAUNCHES["paged_decode_attention"]
        out = paged_decode_attention(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_decode_attention"] == before + 1
        torch.testing.assert_close(out, paged_decode_attention_ref(q, pk, pv, table, lens),
                                   **CUDA_TOL[dtype])
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["identity", "lower"])
def test_cuda_tree_kernels_match_plain_versions(dtype, mask):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(3)
    # The driven shape, small ones, a 1024-key prefix (past the tree kernels'
    # shared-memory copy: keys from shared and from device memory) and A=32.
    for b, a, bs, n_pages, hq, hkv, d in [(128, 8, 16, 10, 32, 8, 128), (6, 1, 1, 7, 4, 2, 16),
                                          (5, 4, 3, 4, 8, 8, 64), (4, 16, 4, 3, 8, 2, 64),
                                          (4, 8, 16, 64, 32, 8, 128), (5, 32, 4, 6, 8, 2, 64)]:
        q, pk, pv, table, lens, (ks, vs) = _cuda_paged_case(gen, dtype, b, bs, n_pages, hq,
                                                            hkv, d, a=a)
        tm = None if mask == "identity" else torch.tril(
            torch.ones(a, a, dtype=torch.bool, device="cuda"))
        before = LAUNCHES["paged_tree_decode_attention"]
        out = paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens, tm)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_tree_decode_attention"] == before + 1
        ref = paged_tree_decode_attention_ref(q, pk, pv, table, ks, vs, lens, tm)
        torch.testing.assert_close(out, ref, **CUDA_TOL[dtype])
        # Dense prefix: the gathered pages as a cache of any length S.
        kc = pk[table.long().clamp(0, pk.shape[0] - 1)].reshape(b, -1, hkv, d).contiguous()
        vc = pv[table.long().clamp(0, pv.shape[0] - 1)].reshape(b, -1, hkv, d).contiguous()
        before = LAUNCHES["tree_decode_attention"]
        dense = tree_decode_attention(q, kc, vc, ks, vs, lens, tm)
        torch.cuda.synchronize()
        assert LAUNCHES["tree_decode_attention"] == before + 1
        torch.testing.assert_close(dense, tree_decode_attention_ref(q, kc, vc, ks, vs, lens, tm),
                                   **CUDA_TOL[dtype])


# (rows, A, block size, pages, Hq, Hkv, D, lengths): the tree kernels copy
# a row's first 178 keys (bf16 D=128, G=4, A=8; 84 at float32) into shared
# memory and read the rest from device memory.  None: random lengths below
# the pages' capacity.
IDENTITY_CASES = {
    "small": (9, 8, 4, 6, 32, 8, 128, None),
    "phase 11": (128, 8, 16, 10, 32, 8, 128, "129-159"),
    "every residue mod 32": (33, 8, 4, 16, 32, 8, 128, "residues"),
    "prefix past the copy": (6, 8, 16, 64, 32, 8, 128,
                             [1023, 178, 179, 84, 85, 600]),
    "D=64": (9, 8, 4, 10, 8, 2, 64, None),
    "D=256": (7, 4, 8, 8, 8, 2, 256, None),
    "two query groups": (5, 4, 4, 8, 24, 2, 64, None),
    "A=1": (9, 1, 4, 10, 32, 8, 128, None),
    "A=32": (5, 32, 4, 10, 8, 2, 64, None),
}


def _plan_parts(b, hq, hkv, limit):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return decode_parts(b * hkv * -(-(hq // hkv) // 8), limit, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(IDENTITY_CASES))
def test_cuda_tree_identity_mask_is_decode_with_the_entry_appended(dtype, case):
    """The four decode kernels share one body: under the identity mask,
    candidate a of the tree kernels (dense and paged) is the dense decode
    kernel unsplit (one part of S: the wrapper wherever its plan gives one,
    else ``decode_attention_split(..., 1)``) over the cache with entry a
    written at kv_len, bit for bit, and the paged decode kernel is the
    dense one on the gathered pages; at the driven shape, at every length
    residue of the 32-key steps, with the prefix past the shared-memory
    copy, D=64 and 256 (two chunks a lane at float32), two query groups,
    A=1 and A=32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, a, bs, n_pages, hq, hkv, d, lengths = IDENTITY_CASES[case]
    q, pk, pv, table, lens, (ks, vs) = _cuda_paged_case(gen, dtype, b, bs, n_pages, hq, hkv,
                                                        d, a=a)
    full = n_pages * bs
    if lengths == "129-159":
        lens = torch.randint(129, full, (b,), generator=gen, device="cuda", dtype=torch.int32)
    elif lengths == "residues":
        lens = torch.tensor([0] + [r + 32 * (r % 2) for r in range(32)], dtype=torch.int32,
                            device="cuda")
    elif lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    lens = lens.clamp(max=full - 1)
    kc = pk[table.long().clamp(0, pk.shape[0] - 1)].reshape(b, -1, hkv, d).contiguous()
    vc = pv[table.long().clamp(0, pv.shape[0] - 1)].reshape(b, -1, hkv, d).contiguous()
    dense = tree_decode_attention(q, kc, vc, ks, vs, lens)
    paged = paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens)
    rows = torch.arange(b, device="cuda")
    for j in range(a):
        k2, v2 = kc.clone(), vc.clone()
        k2[rows, lens.long()] = ks[:, j]
        v2[rows, lens.long()] = vs[:, j]
        step = decode_attention_split(q[:, j].contiguous(), k2, v2, lens + 1, 1)
        assert torch.equal(step, dense[:, j]) and torch.equal(step, paged[:, j]), j
        if _plan_parts(b, hq, hkv, full) == 1:
            assert torch.equal(decode_attention(q[:, j].contiguous(), k2, v2, lens + 1), step)
    assert torch.equal(paged_decode_attention(q[:, 0].contiguous(), pk, pv, table, lens),
                       decode_attention(q[:, 0].contiguous(), kc, vc, lens))
