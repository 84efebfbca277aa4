"""S split across blocks in the dense and paged decode kernels.

Where the unsplit grid (rows x KV heads x query groups) is too small for
the card, ``decode_attention`` and ``paged_decode_attention`` split each
row's keys into parts, each attended by the same body, and merge the
parts' float32 outputs by log-sum-exp.  Held here, on the CPU:

* the plan (``ops.decode_parts``, shapes only): one part at the main
  path's shapes (phases 7 and 10, 25(f), every phase-3 grid shape with S
  at most 160), several at 25(e)'s (8 rows x 32,768, 32/8 heads), enough
  blocks for the card; parts of whole multiples of 256 keys (512, the
  kernels' ``kPartKeys``); a dense S and a paged ``n_pages * bs`` of the
  same length split alike;
* the plain model of the split (``decode_attention_split_ref``,
  ``paged_decode_attention_split_ref``), dense and paged, with and without
  ``return_lse`` and a head window, against the JAX package's Pallas
  kernels in interpret mode (float32, small widths, S = 2048-4096) within
  atol = rtol = 1e-5, its ``lse`` against a float64 log-sum-exp;
* the split model against the unsplit plain version within phase 25(e)'s
  bars (bf16: one bf16 ulp of the row's largest |out|; float32: 2e-6 of
  the row's largest attention over |V|), and bit for bit on rows whose
  keys all fall in the first part.

On a CUDA machine (``pytest -m cuda``; no JAX there) the kernels are held
against the split model, and at ``parts = 1`` against the unsplit plain
version.
"""

import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    decode_attention_split,
    decode_attention_split_ref,
    decode_parts,
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_decode_attention_split,
    paged_decode_attention_split_ref,
)
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import SPLIT_KEYS, part_keys

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
H100_SMS = 132


def _blocks(b, hq, hkv):
    return b * hkv * ops.query_groups(hq // hkv)


# chip_smoke.py phase 3's grids (the dense and paged decode kernels') and
# the driven shapes: phase 7's and 25(f)'s decode step (128 slots of 160,
# 32/8), phase 10's (10 pages of 16).
PHASE3_DENSE = [(n, s, hq, hkv) for n in (1, 128, 1000) for s in (1, 160, 4096)
                for hq, hkv in ((32, 8), (8, 8), (4, 1))]
PHASE3_PAGED = [(n, bs * npg, hq, hkv) for n in (1, 128) for bs, npg in
                ((1, 37), (3, 11), (4, 40), (16, 10)) for hq, hkv in ((32, 8), (4, 1))]
MAIN_SHAPES = [(128, 160, 32, 8)] + [x for x in PHASE3_DENSE + PHASE3_PAGED if x[1] <= 160]


@pytest.mark.parametrize("n,limit,hq,hkv", MAIN_SHAPES)
def test_plan_gives_one_part_on_the_main_shapes(n, limit, hq, hkv):
    assert decode_parts(_blocks(n, hq, hkv), limit, H100_SMS) == 1


def test_plan_splits_the_long_cache_of_few_rows():
    blocks = _blocks(8, 32, 8)
    assert blocks == 64
    parts = decode_parts(blocks, 32768, H100_SMS)
    assert parts > 1 and parts * blocks >= H100_SMS
    keys = part_keys(32768, parts)
    assert keys % 256 == 0 and (parts - 1) * keys < 32768 <= parts * keys
    # A grid that fills the card or a short cache stays whole.
    assert decode_parts(H100_SMS, 32768, H100_SMS) == 1
    assert decode_parts(blocks, SPLIT_KEYS, H100_SMS) == 1


@pytest.mark.parametrize("limit", [1, 511, 512, 513, 2048, 4096, 5000, 32768, 131072])
@pytest.mark.parametrize("blocks", [1, 8, 64, 131])
def test_parts_are_whole_multiples_of_the_kernels_key_unit(limit, blocks):
    parts = decode_parts(blocks, limit, H100_SMS)
    keys = part_keys(limit, parts)
    assert keys % SPLIT_KEYS == 0 and SPLIT_KEYS % 256 == 0
    assert (parts - 1) * keys < limit <= parts * keys       # no empty part
    # The same key limit gives the same parts, dense (S) or paged
    # (n_pages * bs), at any block size.
    for bs in (1, 16, 3):
        n_pages = -(-limit // bs)
        if n_pages * bs == limit:
            assert decode_parts(blocks, n_pages * bs, H100_SMS) == parts
    # Every shape's keys per body iteration divide the part: 4 warps x
    # (32 / lanes per key) keys x kUnroll / chunks per lane steps.
    for lanes in (1, 2, 4, 8, 16, 32):
        for steps in (4, 2):
            assert keys % (4 * (32 // lanes) * steps) == 0


def test_the_kernels_key_unit_is_the_plans():
    text = (_build.CSRC / "decode_split.cuh").read_text()
    assert int(re.search(r"constexpr int kPartKeys = (\d+);", text).group(1)) == SPLIT_KEYS


def _inputs(seed, b, s, hq, hkv, d=16, lens=None):
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, hq, d)).astype(np.float32)
    k = g.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = g.normal(size=(b, s, hkv, d)).astype(np.float32)
    if lens is None:
        lens = [0, 1, SPLIT_KEYS, SPLIT_KEYS + 1, s - 300, s][:b]
    return q, k, v, np.array(lens, dtype=np.int32)


def _lse64(q, k, kv_len, group, q_head0=0):
    """float64 log-sum-exp of each row's and head's scaled scores."""
    b, hq, d = q.shape
    out = np.full((b, hq), -np.inf)
    for r in range(b):
        n = int(kv_len[r])
        for j in range(hq if n else 0):
            sc = (k[r, :n, (q_head0 + j) // group].astype(np.float64)
                  @ q[r, j].astype(np.float64) / math.sqrt(d))
            out[r, j] = sc.max() + math.log(np.exp(sc - sc.max()).sum())
    return out


@pytest.mark.parametrize("s,parts", [(2048, 2), (2048, 3), (4096, 4), (4096, 8)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (8, 2)])
def test_split_model_matches_the_pallas_kernel(s, parts, hq, hkv):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import decode_attention as jax_kernel

    q, k, v, lens = _inputs(parts + hq, 6, s, hq, hkv)
    kern = np.asarray(jax_kernel(*(jnp.asarray(x) for x in (q, k, v, lens))))
    tq, tk, tv, tl = (torch.from_numpy(x) for x in (q, k, v, lens))
    out = decode_attention_split_ref(tq, tk, tv, tl, parts)
    np.testing.assert_allclose(out.numpy(), kern, **TOL)
    np.testing.assert_array_equal(out.numpy()[0], 0.0)          # kv_len = 0
    out, lse = decode_attention_split_ref(tq, tk, tv, tl, parts, return_lse=True)
    np.testing.assert_allclose(out.numpy(), kern, **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, lens, hq // hkv), **TOL)
    assert bool(torch.isneginf(lse[0]).all())
    # A head window: those heads of the Pallas kernel's whole call.
    g = hq // hkv
    for h0, n in ((0, g), (g // 2, g), (hq - 1, 1)):
        win = tq[:, h0:h0 + n].contiguous()
        out, lse = decode_attention_split_ref(win, tk, tv, tl, parts, q_head0=h0,
                                              num_heads=hq, return_lse=True)
        np.testing.assert_allclose(out.numpy(), kern[:, h0:h0 + n], **TOL)
        np.testing.assert_allclose(lse.numpy(), _lse64(q[:, h0:h0 + n], k, lens, g, h0),
                                   **TOL)
        got = decode_attention_split_ref(win, tk, tv, tl, parts, q_head0=h0, num_heads=hq)
        np.testing.assert_allclose(got.numpy(), kern[:, h0:h0 + n], **TOL)


def _paged(seed, b, bs, n_pages, hq, hkv, d=16):
    """Pools, a shuffled page table whose entries past each row's live
    pages hold the sentinel P or a stale id, and lengths across parts."""
    g = np.random.default_rng(seed)
    p = b * n_pages
    q = g.normal(size=(b, hq, d)).astype(np.float32)
    pk, pv = (g.normal(size=(p, bs, hkv, d)).astype(np.float32) for _ in range(2))
    table = g.permutation(p).reshape(b, n_pages).astype(np.int32)
    full = n_pages * bs
    lens = np.array([0, 1, SPLIT_KEYS + bs // 2, full - bs // 2, full][:b], np.int32)
    for r in range(b):
        live = -(-int(lens[r]) // bs)
        table[r, live:] = np.where(np.arange(n_pages - live) % 2, p, table[0, 0])
    return q, pk, pv, table, lens


@pytest.mark.parametrize("bs,n_pages,parts", [(16, 128, 2), (64, 64, 4), (48, 50, 3)])
def test_paged_split_model_matches_the_pallas_kernel(bs, n_pages, parts):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.ops import paged_decode_attention as jax_kernel

    args = _paged(bs + parts, 5, bs, n_pages, 8, 2)
    kern = np.asarray(jax_kernel(*(jnp.asarray(x) for x in args)))
    out = paged_decode_attention_split_ref(*(torch.from_numpy(x) for x in args), parts)
    np.testing.assert_allclose(out.numpy(), kern, **TOL)
    np.testing.assert_array_equal(out.numpy()[0], 0.0)
    # The pages gathered densely split alike.
    q, pk, pv, table, lens = (torch.from_numpy(x) for x in args)
    idx = table.long().clamp(0, pk.shape[0] - 1)
    dense = [x[idx].reshape(table.shape[0], -1, *x.shape[2:]) for x in (pk, pv)]
    assert torch.equal(out, decode_attention_split_ref(q, *dense, lens, parts))


def bf16_ulp(x):
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_split_model_is_the_unsplit_one_within_the_split_bars(parts):
    s = 4096
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(parts, 6, s, 8, 2, d=64))
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        whole = decode_attention_ref(qd, kd, vd, lens).float()
        split = decode_attention_split_ref(qd, kd, vd, lens, parts).float()
        rows = lens > 0
        diff = (split - whole).abs().amax(dim=(1, 2))[rows]
        if dtype == torch.bfloat16:
            assert bool((diff <= bf16_ulp(whole.abs().amax(dim=(1, 2))[rows])).all()), diff
        else:
            scale = decode_attention_ref(qd, kd, vd.abs(), lens).amax(dim=(1, 2))[rows]
            assert bool((diff <= 2e-6 * scale).all()), diff / scale
        assert bool((split[~rows] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_within_the_first_part_equal_the_unsplit_version_bit_for_bit(dtype):
    s, parts = 4096, 4                        # parts of 1024 keys
    lens = [0, 1, 700, 1023, 1024, 1025, 4096]
    q, k, v, tl = (torch.from_numpy(x) for x in _inputs(9, len(lens), s, 8, 2, lens=lens))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    split = decode_attention_split_ref(q, k, v, tl, parts)
    whole = decode_attention_ref(q, k, v, tl)
    inside = tl <= part_keys(s, parts)
    assert torch.equal(split[inside], whole[inside])
    out, lse = decode_attention_split_ref(q, k, v, tl, parts, return_lse=True)
    want, want_lse = decode_attention_ref(q, k, v, tl, return_lse=True)
    assert torch.equal(out[inside], want[inside]) and torch.equal(lse[inside], want_lse[inside])


def test_split_wrappers_on_the_cpu_run_the_split_model():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(3, 6, 2048, 4, 1))
    assert torch.equal(decode_attention_split(q, k, v, lens, 3),
                       decode_attention_split_ref(q, k, v, lens, 3))
    # One part is the unsplit plain version, bit for bit; the plain
    # wrapper never splits on the CPU.
    assert torch.equal(decode_attention_split(q, k, v, lens, 1), decode_attention(q, k, v, lens))
    args = [torch.from_numpy(x) for x in _paged(4, 5, 16, 64, 4, 1)]
    assert torch.equal(paged_decode_attention_split(*args, 1), paged_decode_attention(*args))
    assert torch.equal(paged_decode_attention_split(*args, 2),
                       paged_decode_attention_split_ref(*args, 2))
    assert torch.equal(paged_decode_attention(*args), paged_decode_attention_ref(*args))


# ---------------------------------------------------------------------------
# On the card: the kernels against the split model
# ---------------------------------------------------------------------------

CUDA_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5), torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7)}


def _cuda_case(gen, dtype, n, s, hq, hkv, d):
    q = torch.randn((n, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((n, s, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.randint(0, s + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
    lens[:4] = torch.tensor([0, 1, s, min(s, SPLIT_KEYS)], dtype=torch.int32)[:n]
    return q, k, v, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_kernel_matches_the_split_model(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for n, s, hq, hkv, d in [(8, 4096, 32, 8, 128), (5, 3000, 8, 1, 64), (6, 1100, 40, 8, 128),
                             (4, 2048, 12, 12, 16)]:
        q, k, v, lens = _cuda_case(gen, dtype, n, s, hq, hkv, d)
        for parts in (1, 2, 3, 8):
            what = f"N={n} S={s} {hq}/{hkv} D={d} parts={parts}"
            out = decode_attention_split(q, k, v, lens, parts)
            torch.testing.assert_close(out, decode_attention_split_ref(q, k, v, lens, parts),
                                       **CUDA_TOL[dtype], msg=lambda m: f"{what}: {m}")
            got, lse = decode_attention_split(q, k, v, lens, parts, return_lse=True)
            ref, ref_lse = decode_attention_split_ref(q, k, v, lens, parts, return_lse=True)
            torch.testing.assert_close(got, ref, **CUDA_TOL[torch.float32])
            torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
            assert torch.equal(out, got.to(dtype)), what      # out is that rounded once
            assert bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())
            if parts == 1:
                torch.testing.assert_close(out, decode_attention_ref(q, k, v, lens),
                                           **CUDA_TOL[dtype])
            # Rows whose keys fall in the first part: the unsplit kernel's bits.
            first = lens <= part_keys(s, parts)
            one = decode_attention_split(q, k, v, lens, 1)
            assert torch.equal(out[first], one[first]), what
            # A head window: those heads of the whole call at the same parts.
            g = hq // hkv
            win = q[:, g // 2:g // 2 + g].contiguous()
            got = decode_attention_split(win, k, v, lens, parts, q_head0=g // 2, num_heads=hq)
            assert torch.equal(got, out[:, g // 2:g // 2 + g]), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_split_kernel_matches_the_model_and_the_dense_kernel(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for n, bs, n_pages, hq, hkv, d in [(8, 16, 256, 32, 8, 128), (1, 16, 2048, 32, 8, 128),
                                       (3, 3, 700, 4, 1, 64), (5, 1, 1500, 8, 2, 16)]:
        q = torch.randn((n, hq, d), generator=gen, device="cuda").to(dtype)
        pk, pv = (torch.randn((n * n_pages, bs, hkv, d), generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        table = torch.randperm(n * n_pages, generator=gen, device="cuda").reshape(
            n, n_pages).to(torch.int32)
        full = n_pages * bs
        lens = torch.randint(0, full + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        lens[0] = full
        dense = [x[table.long()].reshape(n, full, hkv, d) for x in (pk, pv)]
        for parts in (1, 2, 5):
            what = f"N={n} bs={bs} pages={n_pages} {hq}/{hkv} D={d} parts={parts}"
            out = paged_decode_attention_split(q, pk, pv, table, lens, parts)
            torch.testing.assert_close(
                out, paged_decode_attention_split_ref(q, pk, pv, table, lens, parts),
                **CUDA_TOL[dtype], msg=lambda m: f"{what}: {m}")
            assert torch.equal(out, decode_attention_split(q, *dense, lens, parts)), what
        assert torch.equal(paged_decode_attention(q, pk, pv, table, lens),
                           decode_attention(q, *dense, lens))
