"""The port's RG-LRU scan (``repro_torch.kernels.rglru``) against the JAX
reference's, live, on the same inputs (CPU).

On the CPU the wrapper runs its plain version (a sequential fp32 loop);
the reference's Pallas kernel runs in interpret mode, at T and C that its
blocks divide, and its ``associative_scan`` oracle (``rglru_scan_ref``)
at any T.  Tolerances are those of the reference's own kernel tests
(``tests/test_kernels.py``): 2e-5 for the block sweep, 1e-5 (fp32) and
4e-2 (bf16) absolute for the dtype cases; the two sides sum the same
recurrence in another order (sequential against a parallel tree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_ref
from repro_torch.kernels.rglru import ops, ref


def _inputs(b, t, c, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, c))))
    x = rng.standard_normal((b, t, c))
    return a.astype(np.float32), x.astype(np.float32)


def _jnp(a, dt):
    return jnp.asarray(a, dt)


def _torch(a, dt):
    return torch.as_tensor(a).to(dt)


@pytest.mark.parametrize("b,t,c,tb,cb", [
    (1, 128, 64, 32, 32), (2, 256, 128, 64, 64), (1, 64, 256, 64, 128),
    (3, 128, 64, 128, 64),
])
def test_plain_version_matches_pallas_kernel(b, t, c, tb, cb):
    a, x = _inputs(b, t, c, seed=t + c)
    expect = jax_rglru_scan(_jnp(a, jnp.float32), _jnp(x, jnp.float32),
                            t_block=tb, c_block=cb, interpret=True)
    got = ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 4e-2)])
def test_plain_version_matches_pallas_kernel_dtypes(dt, tol):
    a, x = _inputs(2, 128, 64, seed=1)
    expect = jax_rglru_scan(_jnp(a, getattr(jnp, dt)),
                            _jnp(x, getattr(jnp, dt)), t_block=64,
                            c_block=64, interpret=True)
    got = ops.rglru_scan(_torch(a, getattr(torch, dt)),
                         _torch(x, getattr(torch, dt)))
    assert got.dtype == getattr(torch, dt)
    err = np.abs(got.float().numpy()
                 - np.asarray(expect, np.float32)).max()
    assert err < tol


@pytest.mark.parametrize("t", [1, 7, 33])
@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 4e-2)])
def test_plain_version_matches_oracle_at_ragged_t(t, dt, tol):
    """Any T: the Pallas kernel needs t_block | T, its oracle does not."""
    a, x = _inputs(2, t, 40, seed=t)
    expect = jax_rglru_ref(_jnp(a, getattr(jnp, dt)),
                           _jnp(x, getattr(jnp, dt)))
    got = ref.rglru_scan_ref(_torch(a, getattr(torch, dt)),
                             _torch(x, getattr(torch, dt)))
    err = np.abs(got.float().numpy()
                 - np.asarray(expect, np.float32)).max()
    assert got.shape == (2, t, 40) and err < tol


def test_plain_version_is_the_recurrence():
    """h_t = a_t h_{t-1} + x_t from zero, step by step; mixed dtypes read
    as fp32 and write in x's dtype; strided views are read as they are."""
    a, x = _inputs(2, 9, 6, seed=4)
    h = np.zeros((2, 6), np.float32)
    expect = []
    for t in range(9):
        h = a[:, t] * h + x[:, t]
        expect.append(h)
    got = ref.rglru_scan_ref(torch.as_tensor(a), torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.stack(expect, 1))
    mixed = ref.rglru_scan_ref(torch.as_tensor(a).bfloat16(),
                               torch.as_tensor(x))
    assert mixed.dtype == torch.float32
    wide = torch.as_tensor(np.concatenate([x, x], axis=2))[:, :, ::2]
    assert not wide.is_contiguous()
    np.testing.assert_array_equal(
        ops.rglru_scan(torch.as_tensor(a), wide).numpy(),
        ref.rglru_scan_ref(torch.as_tensor(a), wide.contiguous()).numpy())
