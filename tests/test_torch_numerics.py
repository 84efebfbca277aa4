"""Float32 differences between XLA on the CPU and PyTorch that set the
port's tolerances, pinned as tests.

* ``log``: PyTorch's and XLA's float32 ``log`` differ in the last bit on
  a large share of inputs (never by more than one ulp), so scores and
  Gumbel draws agree to ulps, and actions to near-ties;
* ``sqrt``: XLA's is correctly rounded; the port's plain versions take it
  in float64 and round, which gives the same bits (PyTorch's vectorised
  CPU ``sqrt`` does not always);
* ``a * b + c``: XLA on the CPU fuses it into one FMA, so the reference's
  value updates and the scale-and-shift of ``uniform`` round once where
  separate float32 operations round twice.

Run with ``-s`` to print the measured shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.kernels.tree_select.ref import _sqrt

torch.set_num_threads(2)

N = 1 << 21


def _uniform(seed, lo=1e-7, hi=1.0):
    rs = np.random.default_rng(seed)
    return (rs.random(N) * (hi - lo) + lo).astype(np.float32)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_log_differs_by_at_most_one_ulp():
    u = _uniform(0)
    xla = np.asarray(jax.jit(jnp.log)(u))
    port = torch.log(torch.from_numpy(u)).numpy()
    share = float((xla != port).mean())
    gumbel_xla = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u))
    gumbel_port = (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()
    gumbel_share = float((gumbel_xla != gumbel_port).mean())
    print(f"log: {share:.4f} of {N} inputs differ; -log(-log(u)): {gumbel_share:.4f}; "
          f"max gumbel abs diff {float(np.abs(gumbel_xla - gumbel_port).max())!r}")
    assert _ulps(xla, port).max() <= 1
    assert np.abs(gumbel_xla - gumbel_port).max() <= 1e-6 + 1e-6 * np.abs(gumbel_xla).max()


def test_float64_sqrt_is_xlas_sqrt():
    x = _uniform(1, 0.0, 100.0)
    xla = np.asarray(jax.jit(jnp.sqrt)(x))
    torch_f32 = torch.sqrt(torch.from_numpy(x)).numpy()
    print(f"sqrt: torch float32 differs from XLA on {float((torch_f32 != xla).mean()):.4f}")
    np.testing.assert_array_equal(_sqrt(torch.from_numpy(x)).numpy(), xla)


def test_xla_fuses_multiply_add():
    a, b, c = _uniform(2), _uniform(3), _uniform(4)
    xla = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    separate = a * b + c
    print(f"a*b+c: XLA differs from separately rounded ops on "
          f"{float((xla != separate).mean()):.4f}, from the fused result on "
          f"{float((xla != fused).mean()):.4f}")
    np.testing.assert_array_equal(xla, fused)
    assert (xla != separate).any()
