"""The port's direct conv (K1's plain version and the conv dispatch) on the
CPU against the JAX package, on the same numpy inputs.

rtol = atol = 1e-5: both sides sum in f32, in different orders.  The
reference is ``repro.kernels.ref`` (the ``xla`` path); where the installed
Pallas has ``unblocked``, the JAX kernel in interpret mode is a second
reference on top."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from repro.core import conv as jax_conv
from repro.kernels import ref as jax_ref
from repro.kernels.conv2d_direct import conv2d_direct as jax_conv2d_direct
from repro_torch.core.conv import conv2d_fwd, lane_ok
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [
    # n, h, w, c, k, r, stride, pad  (the shapes of tests/test_kernels_conv.py)
    (2, 8, 8, 8, 16, 3, 1, 1),
    (1, 14, 14, 16, 32, 1, 1, 0),
    (2, 16, 16, 8, 8, 3, 2, 1),
    (1, 7, 7, 8, 16, 3, 1, 1),
    (1, 9, 9, 8, 8, 3, 1, 1),         # P/Q that no 4-row block divides
    (1, 8, 8, 8, 8, 1, 2, 0),
    (1, 12, 12, 8, 8, 5, 1, 2),       # 5x5 halo
    (2, 8, 8, 16, 16, 3, 1, 1),
    (2, 16, 16, 8, 8, 3, 2, 1),
    (1, 24, 24, 8, 16, 7, 2, 3),      # 7x7 stride-2 halo
    (3, 11, 13, 5, 7, 3, 2, 1),       # ragged C and K, H != W
    (1, 56, 56, 8, 16, 7, 2, 3),      # the stem (configs/shapes.STEM_CONV), reduced
    (1, 32, 32, 3, 16, 7, 2, 3),      # the C=3 stem: the reference path
]


def _data(case, seed=0):
    n, h, w, c, k, r, stride, pad = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((r, r, c, k)) * 0.1).astype(np.float32)
    return x, wt


def _epilogue_data(case, *, bias, bn, residual, relu, seed=1):
    n, h, w, c, k, r, stride, pad = case
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - r) // stride + 1
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(bias=f(k) if bias else None,
                scale=f(k) if bn else None, shift=f(k) if bn else None,
                residual=f(n, p, q, k) if residual else None, relu=relu)


def _torch(kw):
    return {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for key, v in kw.items()}


def _jax(kw):
    return {key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for key, v in kw.items()}


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_ref(case):
    x, wt = _data(case)
    stride, pad = case[6], case[7]
    out = k1.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=stride, padding=pad)
    exp = jax_ref.conv2d(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                         padding=pad)
    assert out.dtype == torch.float32 and out.shape == exp.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_port_ref_matches_jax_ref(case):
    x, wt = _data(case)
    stride, pad = case[6], case[7]
    epi = _epilogue_data(case, bias=True, bn=True, residual=True, relu=True)
    out = ref.conv2d_fused(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=stride, padding=pad, **_torch(epi))
    exp = jax_ref.conv2d_fused(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                               padding=pad, **_jax(epi))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("bias,bn,residual,relu",
                         list(itertools.product([False, True], repeat=4)))
def test_every_epilogue_combination(bias, bn, residual, relu):
    """Scale, shift, bias, residual, relu in the reference's order, on a
    case with a P/Q tail (p = q = 9)."""
    case = (2, 9, 9, 8, 16, 3, 1, 1)
    x, wt = _data(case)
    epi = _epilogue_data(case, bias=bias, bn=bn, residual=residual, relu=relu)
    out = k1.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=1, padding=1, **_torch(epi))
    exp = jax_ref.conv2d_fused(jnp.asarray(x), jnp.asarray(wt), stride=1,
                               padding=1, **_jax(epi))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_conv2d_fwd_matches_jax_dispatch(case):
    """The port's dispatch (K1 for lane-aligned C/K, the reference path
    otherwise) against ``repro.core.conv.conv2d_fwd(impl="xla")``, with the
    folded-BN + residual + relu epilogue of a bottleneck's last conv."""
    x, wt = _data(case)
    stride, pad = case[6], case[7]
    epi = _epilogue_data(case, bias=False, bn=True, residual=True, relu=True)
    out = conv2d_fwd(torch.from_numpy(x), torch.from_numpy(wt),
                     stride=stride, padding=pad, **_torch(epi))
    exp = jax_conv.conv2d_fwd(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                              padding=pad, impl="xla", **_jax(epi))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_tail_with_fused_residual():
    """A P tail (p = 9) with bias + residual + relu, the case the reference
    pins for its masked tail stores."""
    case = (1, 9, 9, 8, 16, 3, 1, 1)
    x, wt = _data(case)
    epi = _epilogue_data(case, bias=True, bn=False, residual=True, relu=True)
    out = k1.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=1, padding=1, **_torch(epi))
    exp = jax_ref.conv2d_fused(jnp.asarray(x), jnp.asarray(wt), stride=1,
                               padding=1, **_jax(epi))
    assert out.shape == (1, 9, 9, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[9]])
def test_plain_matches_jax_interpret_kernel(case):
    if not hasattr(jax_pallas, "unblocked"):
        pytest.skip("this jax's Pallas has no `unblocked`: the JAX kernel "
                    "cannot run in interpret mode here")
    x, wt = _data(case)
    stride, pad = case[6], case[7]
    epi = _epilogue_data(case, bias=True, bn=True, residual=True, relu=True)
    out = k1.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=stride, padding=pad, **_torch(epi))
    exp = jax_conv2d_direct(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                            padding=pad, rb_p=4, interpret=True, **_jax(epi))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, wt = _data(CASES[0])
    before = k1.launches
    out = k1.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=1, padding=1)
    plain = k1.conv2d_direct_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                   stride=1, padding=1)
    assert k1.launches == before
    assert torch.equal(out, plain)


@pytest.mark.parametrize("bad,match", [
    (dict(w=np.zeros((3, 3, 4, 16), np.float32)), "C=4"),
    (dict(bias=np.zeros(15, np.float32)), "bias"),
    (dict(scale=np.ones(16, np.float32)), "both scale and shift"),
    (dict(residual=np.zeros((2, 7, 8, 16), np.float32)), "residual"),
    (dict(stride=0), "stride"),
    (dict(x=np.zeros((2, 1, 1, 8), np.float32), padding=0), "empty"),
])
def test_wrapper_rejects_bad_shapes(bad, match):
    x, wt = _data(CASES[0])
    kw = dict(x=x, w=wt, stride=1, padding=1)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        k1.conv2d_direct(**_torch(kw))


def test_lane_rule_matches_reference():
    for c, k in itertools.product([3, 4, 8, 16, 64], [7, 8, 64, 2048]):
        assert lane_ok(c, k) == jax_conv.lane_ok(c, k)
