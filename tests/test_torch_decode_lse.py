"""The decode kernel's two options for placed caches, on the plain version.

``decode_attention(..., return_lse=True)`` returns a float32 ``out`` and
each head's log-sum-exp, by which the parts of a cache split over S merge
(``layers.merge_by_lse``, the split-KV decode cell); ``q_head0`` /
``num_heads`` give it a window of the model's query heads (a rank's under
tensor parallelism), each reading its KV head from the whole cache.  Held,
float32 at tiny shapes:

* ``out`` against the JAX package's ``repro.models.layers.decode_attention``
  (its XLA oracle; rows with a key) within atol = rtol = 1e-5, ``lse``
  against a float64 log-sum-exp of the same scores within 1e-5;
* a merge of 2, 3 and 4 parts of S equal to the unsplit call within
  rtol 1e-5 (``out`` and ``lse``), parts with no key among them; an empty
  row gives ``lse = -inf`` and ``out = 0``, split or not;
* a head window equal to those heads of a whole call, windows that cut a
  group included;
* the split-S cache write (``layers._write_slice``) on each part equal to
  the unsplit write.

On a CUDA machine the kernel's options are held against the plain version
(``pytest -m cuda``; no JAX there).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.models import layers

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
# Rows' lengths: 0 (no key), 1, off the parts' edges, S.
LENS = (0, 1, 5, 11, 16, 24)


def _inputs(seed, b, s, hq, hkv, d, lens=LENS):
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, hq, d)).astype(np.float32)
    k = g.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = g.normal(size=(b, s, hkv, d)).astype(np.float32)
    kv_len = np.array([lens[i % len(lens)] for i in range(b)], dtype=np.int32)
    return q, k, v, kv_len


def _lse64(q, k, kv_len, hq, hkv):
    """float64 log-sum-exp of each row's and head's scaled scores."""
    b, s, _, d = k.shape
    g = hq // hkv
    out = np.full((b, hq), -np.inf)
    for r in range(b):
        n = int(kv_len[r])
        if n == 0:
            continue
        for h in range(hq):
            sc = k[r, :n, h // g].astype(np.float64) @ q[r, h].astype(np.float64) / math.sqrt(d)
            m = sc.max()
            out[r, h] = m + math.log(np.exp(sc - m).sum())
    return out


@pytest.mark.parametrize("hq,hkv", [(4, 1), (8, 2), (4, 4)])
def test_lse_matches_the_jax_oracle_and_float64(hq, hkv):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import decode_attention as jax_oracle

    q, k, v, kv_len = _inputs(0, 6, 24, hq, hkv, 16)
    out, lse = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, kv_len)),
                                return_lse=True)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (6, hq)
    oracle = np.asarray(jax_oracle(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(kv_len)))[:, 0]
    rows = kv_len > 0        # the oracle gives an empty row the mean of V
    np.testing.assert_allclose(out.numpy()[rows], oracle[rows], **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, kv_len, hq, hkv), **TOL)
    # Without the option: the same numbers, in q's dtype.
    plain = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, kv_len)))
    assert torch.equal(plain, out)


def _split_call(q, k, v, kv_len, parts):
    """Each of ``parts`` even slices of S attended with its local length
    ``clamp(len - offset, 0, S_local)``, then merged."""
    s = k.shape[1]
    step = s // parts
    outs, lses = [], []
    for i in range(parts):
        lo = i * step
        o, l = decode_attention(q, k[:, lo:lo + step], v[:, lo:lo + step],
                                torch.clamp(kv_len - lo, 0, step), return_lse=True)
        outs.append(o)
        lses.append(l)
    return layers.merge_by_lse(torch.stack(outs), torch.stack(lses))


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_merge_of_parts_equals_the_unsplit_call(parts):
    s = 24
    q, k, v, kv_len = (torch.from_numpy(x) for x in _inputs(parts, 6, s, 8, 2, 16))
    want, want_lse = decode_attention(q, k, v, kv_len, return_lse=True)
    got, got_lse = _split_call(q, k, v, kv_len, parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-6)


def test_empty_row_gives_zero_and_minus_infinity():
    q, k, v, kv_len = (torch.from_numpy(x) for x in _inputs(3, 4, 16, 4, 1, 16, lens=(0,)))
    out, lse = decode_attention(q, k, v, kv_len, return_lse=True)
    assert bool((out == 0).all()) and bool(torch.isneginf(lse).all())
    out, lse = _split_call(q, k, v, kv_len, 4)
    assert bool((out == 0).all()) and bool(torch.isneginf(lse).all())
    one, one_lse = layers.merge_by_lse(out[None], lse[None])
    assert torch.equal(one, out) and bool(torch.isneginf(one_lse).all())


def test_one_part_merges_to_itself_bit_for_bit():
    q, k, v, kv_len = (torch.from_numpy(x) for x in _inputs(4, 6, 24, 8, 2, 16))
    out, lse = decode_attention(q, k, v, kv_len, return_lse=True)
    merged, merged_lse = layers.merge_by_lse(out[None], lse[None])
    assert torch.equal(merged, out) and torch.equal(merged_lse, lse)


# (model heads, KV heads, window start, window heads): whole groups, a
# window cutting one group (2 of 4), one spanning two groups' halves, one
# head, all of them.
WINDOWS = [(8, 2, 0, 4), (8, 2, 2, 2), (8, 2, 2, 4), (8, 2, 5, 1), (8, 2, 0, 8),
           (8, 1, 4, 2), (4, 4, 1, 2)]


@pytest.mark.parametrize("nh,hkv,h0,hq", WINDOWS)
def test_head_window_equals_those_heads_of_a_whole_call(nh, hkv, h0, hq):
    q, k, v, kv_len = (torch.from_numpy(x) for x in _inputs(5, 6, 24, nh, hkv, 16))
    whole, whole_lse = decode_attention(q, k, v, kv_len, return_lse=True)
    win = q[:, h0:h0 + hq].contiguous()
    out = decode_attention(win, k, v, kv_len, q_head0=h0, num_heads=nh)
    np.testing.assert_allclose(out.numpy(), whole[:, h0:h0 + hq].numpy(), rtol=1e-6, atol=1e-7)
    out, lse = decode_attention(win, k, v, kv_len, q_head0=h0, num_heads=nh, return_lse=True)
    np.testing.assert_allclose(out.numpy(), whole[:, h0:h0 + hq].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), whole_lse[:, h0:h0 + hq].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_on_cache_shards_on_plain_tensors_is_the_kernel_call():
    q, k, v, kv_len = (torch.from_numpy(x) for x in _inputs(6, 6, 24, 8, 2, 16))
    assert torch.equal(layers.on_cache_shards(q, k, v, kv_len, 8),
                       decode_attention(q, k, v, kv_len))


@pytest.mark.parametrize("start,s", [(5, 1), (7, 1), (30, 1), (6, 3), ("rows", 1),
                                     ("rows", 3)])
def test_write_on_a_split_cache_equals_the_whole_write(start, s):
    """``_write_slice`` on each of 4 slices of S equals ``_write_cache`` on
    the whole cache: scalar starts (clamped at the end), per-row starts
    (dropped past S), one token and a chunk across a slice's edge."""
    g = np.random.default_rng(7)
    b, big_s, hkv, d = 5, 16, 2, 4
    kc = torch.from_numpy(g.normal(size=(b, big_s, hkv, d)).astype(np.float32))
    vc = torch.from_numpy(g.normal(size=(b, big_s, hkv, d)).astype(np.float32))
    k = torch.from_numpy(g.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(g.normal(size=(b, s, hkv, d)).astype(np.float32))
    st = (torch.tensor([0, 3, 15, 16, 40]) if start == "rows" else torch.tensor(start))
    want_k, want_v = kc.clone(), vc.clone()
    layers._write_cache(want_k, want_v, k, v, st)
    parts = 4
    step = big_s // parts
    got_k, got_v = kc.clone(), vc.clone()
    for i in range(parts):
        layers._write_slice(got_k[:, i * step:(i + 1) * step], got_v[:, i * step:(i + 1) * step],
                            k, v, st, i * step, big_s)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)


# ---------------------------------------------------------------------------
# On the card: the kernel's options against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lse_and_head_window_match_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, s, nh, hkv, d in [(9, 160, 32, 8, 128), (9, 70, 8, 1, 64), (5, 33, 4, 4, 16)]:
        q = torch.randn((n, nh, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((n, s, hkv, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        lens = torch.randint(0, s + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        lens[0] = 0
        out, lse = decode_attention(q, k, v, lens, return_lse=True)
        ref, ref_lse = decode_attention_ref(q, k, v, lens, return_lse=True)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
        assert torch.equal(decode_attention(q, k, v, lens).float(), out.to(dtype).float())
        g = nh // hkv
        for h0, hq in ((0, nh), (g // 2, max(1, g)), (nh - 1, 1)):
            win = q[:, h0:h0 + hq].contiguous()
            got = decode_attention(win, k, v, lens, q_head0=h0, num_heads=nh)
            torch.testing.assert_close(got.float(), decode_attention_ref(
                win, k, v, lens, q_head0=h0, num_heads=nh).float(), rtol=1e-2, atol=1e-5)
