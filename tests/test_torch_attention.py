"""The port's attention kernels' plain versions against the JAX package.

``decode_attention_ref`` and ``flash_attention_ref`` (what the port's
wrappers run on CPU tensors) are held against the JAX Pallas kernels in
interpret mode and against the XLA oracles of ``repro.models.layers``,
float32 at tiny shapes, with ragged ``kv_len`` including 0.  Tolerance:
atol = rtol = 1e-5, for summation order (the Pallas kernels sum keys block
by block, the oracles and the port in one einsum).  The XLA decode oracle
gives a ``kv_len = 0`` row the mean of V (its softmax over all-masked
scores is uniform) where the Pallas kernel and the port give zeros, so
that row is compared with the kernel only.

On a CUDA machine the hand-written kernels are held against their plain
versions (``pytest -m cuda``); those tests import no JAX.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
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


def test_wrappers_reject_other_devices():
    q = torch.zeros(2, 4, 16, device="meta")
    kv = torch.zeros(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_attention(q, kv, kv, 3)
    q4 = torch.zeros(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q4, kv, kv)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, s, hq, hkv, d in [(1, 1, 32, 8, 128), (128, 160, 32, 8, 128),
                             (33, 100, 4, 1, 64), (5, 40, 8, 8, 16)]:
        q, k, v = _cuda_inputs(gen, dtype, (n, hq, d), (n, s, hkv, d), (n, s, hkv, d))
        lens = torch.randint(0, s + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        lens[0] = 0
        before = LAUNCHES["decode_attention"]
        out = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(out, decode_attention_ref(q, k, v, lens), **CUDA_TOL[dtype])
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, s, hq, hkv, d in [(1, 1, 32, 8, 128), (8, 160, 32, 8, 128), (1, 7, 4, 1, 64),
                             (2, 70, 8, 8, 16)]:
        q, k, v = _cuda_inputs(gen, dtype, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
        before = LAUNCHES["flash_attention"]
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + 1
        torch.testing.assert_close(out, flash_attention_ref(q, k, v), **CUDA_TOL[dtype])


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
