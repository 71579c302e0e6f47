"""K5, the port's max-pool kernel, on the CPU against the JAX package.

``maxpool2d_plain`` (what ``maxpool2d`` runs on a CPU tensor) against the
reference's Pallas ``maxpool2d`` in interpret mode and against
``lax.reduce_window`` on the three cases of
``tests/test_kernels_q8_pool.py:171-176``, and against ``F.max_pool2d``,
the library yardstick: all exact (a max is a choice, not a sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.pool2d import maxpool2d as jax_maxpool2d
from repro_torch.kernels import pool2d as k5

CASES = [(3, 2, 1, 12), (2, 2, 0, 8), (3, 1, 1, 7)]   # window, stride, pad, h


def _x(h, seed=0, c=8):
    return np.random.default_rng(seed).standard_normal(
        (2, h, h, c)).astype(np.float32)


def _torch_pool(x, window, stride, pad):
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, pad) \
        .permute(0, 2, 3, 1)


@pytest.mark.parametrize("window,stride,pad,h", CASES)
def test_plain_equals_pallas_interpret(window, stride, pad, h):
    x = _x(h)
    exp = np.asarray(jax_maxpool2d(jnp.asarray(x), window=window,
                                   stride=stride, padding=pad, rb_p=3,
                                   interpret=True))
    before = k5.launches
    got = k5.maxpool2d(torch.from_numpy(x), window=window, stride=stride,
                       padding=pad)
    assert k5.launches == before              # the CPU runs no kernel
    assert got.shape == exp.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("window,stride,pad,h", CASES)
def test_plain_equals_reduce_window(window, stride, pad, h):
    x = _x(h, 1)
    exp = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, stride, stride, 1),
        ((0, 0), (pad, pad), (pad, pad), (0, 0))))
    got = k5.maxpool2d_plain(torch.from_numpy(x), window=window,
                             stride=stride, padding=pad)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("window,stride,pad,h",
                         CASES + [(3, 2, 1, 112), (3, 2, 1, 9)])
def test_plain_equals_max_pool2d(window, stride, pad, h):
    """The yardstick on the reference's cases, the stem pool's 112x112
    plane and an odd one."""
    x = torch.from_numpy(_x(h, 2, c=16 if h > 100 else 8))
    got = k5.maxpool2d(x, window=window, stride=stride, padding=pad)
    assert torch.equal(got, _torch_pool(x, window, stride, pad))


def test_defaults_are_the_resnet_stem_pool():
    x = torch.from_numpy(_x(12, 3))
    assert torch.equal(k5.maxpool2d(x), _torch_pool(x, 3, 2, 1))
    assert k5.maxpool2d(x).shape == (2, 6, 6, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_keeps_its_dtype_and_values(dtype):
    """The max is taken in f32 and cast back: every output is one of the
    inputs, so the result is exact in the input's dtype."""
    x = torch.from_numpy(_x(12, 4)).to(dtype)
    got = k5.maxpool2d(x)
    assert got.dtype == dtype
    assert torch.equal(got, _torch_pool(x.float(), 3, 2, 1).to(dtype))


def test_nan_propagates_as_torch_maximum():
    x = torch.from_numpy(_x(8, 5))
    x[0, 3, 3, 2] = float("nan")
    got = k5.maxpool2d(x)
    assert bool(torch.isnan(got[0, 1:3, 1:3, 2]).all())
    assert int(torch.isnan(got).sum()) == 4


def test_rejects_what_it_does_not_take():
    x = torch.from_numpy(_x(8))
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        k5.maxpool2d(x.double())
    with pytest.raises(ValueError, match="N,H,W,C"):
        k5.maxpool2d(x[0])
    with pytest.raises(ValueError, match="empty output"):
        k5.maxpool2d(x, window=12, padding=0)
    with pytest.raises(ValueError, match="stride"):
        k5.maxpool2d(x, stride=0)
