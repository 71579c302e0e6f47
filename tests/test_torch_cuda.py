"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU with the CUDA toolkit (``nvcc``): a CUDA kernel has
no CPU mode, so elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core.conv import conv2d_train
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

# n, h, w, c, k, r, stride, pad — ragged C/K (no float4 path), P/Q tails,
# 1x1 / 3x3 / 7x7, stride 1 and 2, a plane small enough for the 64x64 tile
CASES = [
    (2, 9, 9, 8, 16, 3, 1, 1),
    (1, 14, 14, 16, 32, 1, 1, 0),
    (2, 16, 16, 8, 8, 3, 2, 1),
    (1, 12, 12, 8, 8, 5, 1, 2),
    (1, 24, 24, 8, 16, 7, 2, 3),
    (3, 11, 13, 5, 7, 3, 2, 1),
    (2, 7, 7, 512, 2048, 1, 1, 0),
    (16, 56, 56, 64, 64, 3, 1, 1),
]
EPILOGUES = [dict(), dict(bn=True, relu=True),
             dict(bn=True, residual=True, relu=True),
             dict(bias=True, bn=True, residual=True, relu=True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _args(case, dev, *, bias=False, bn=False, residual=False, relu=False):
    n, h, w, c, k, r, stride, pad = case
    g = torch.Generator(device=dev).manual_seed(0)
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - r) // stride + 1
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    return dict(x=rnd(n, h, w, c), w=rnd(r, r, c, k) / math.sqrt(r * r * c),
                stride=stride, padding=pad,
                bias=rnd(k) if bias else None,
                scale=rnd(k) if bn else None, shift=rnd(k) if bn else None,
                residual=rnd(n, p, q, k) if residual else None, relu=relu)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_kernel_matches_plain(cuda, case, epi):
    args = _args(case, cuda, **EPILOGUES[epi])
    before = k1.launches
    out = k1.conv2d_direct(**args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    exp = k1.conv2d_direct_plain(**args)
    assert out.shape == exp.shape and out.device == exp.device
    err = float((out - exp).abs().max())
    assert err <= 1e-5 * max(float(exp.abs().max()), 1.0), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    args = _args(CASES[0], cuda)
    with pytest.raises(ValueError, match="float32"):
        k1.conv2d_direct(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        k1.conv2d_direct(**{**args, "x": args["x"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k1.conv2d_direct(**{**args, "w": args["w"].cpu()})


def _rel_err(out, exp):
    return float((out - exp).abs().max()) / float(exp.abs().max())


@pytest.mark.parametrize("r,s", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_kernel_on_dual_subfilters(cuda, r, s):
    """The sub-filters of the phase plan of a 3x3 stride-2 conv, padding 0,
    on the pre-padded dO plane of ResNet-50's 56x56 -> 28x28 layer."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 28 + r - 1, 28 + s - 1, 128), generator=g,
                    device=cuda)
    w = torch.randn((r, s, 128, 128), generator=g, device=cuda) / 16
    before = k1.launches
    out = k1.conv2d_direct(x, w, stride=1, padding=0)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and out.shape == (4, 28, 28, 128)
    assert _rel_err(out, k1.conv2d_direct_plain(x, w, stride=1,
                                                padding=0)) <= 1e-5


# n, h, w, c, k, r, stride, pad
WU_CASES = [
    (3, 11, 13, 5, 7, 3, 2, 1),          # ragged C and K
    (2, 9, 9, 8, 16, 3, 1, 1),           # P/Q tails
    (2, 16, 16, 8, 8, 3, 2, 1),          # stride 2
    (1, 24, 24, 8, 16, 7, 2, 3),         # 7x7 stride-2 halo
    (1, 4, 4, 8, 8, 1, 1, 0),            # one split
    (32, 56, 56, 64, 64, 1, 1, 0),       # 100k-pixel reduction, many splits
    (32, 28, 28, 128, 128, 3, 1, 1),     # the 128x128 tile
    (8, 14, 14, 256, 64, 1, 2, 0),       # the 128x64 tile, 1x1 stride 2
    (4, 7, 7, 2048, 512, 1, 1, 0),
] + [(2, 15, 15, 16, 24, r, 1, r // 2) for r in range(1, 8)]


def _wu_args(case, dev):
    n, h, w, c, k, r, stride, pad = case
    g = torch.Generator(device=dev).manual_seed(2)
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - r) // stride + 1
    return dict(x=torch.randn((n, h, w, c), generator=g, device=dev),
                do=torch.randn((n, p, q, k), generator=g, device=dev),
                stride=stride, padding=pad, filter_rs=(r, r))


@pytest.mark.parametrize("case", WU_CASES)
def test_wu_kernel_matches_plain(cuda, case):
    args = _wu_args(case, cuda)
    before = k2.launches
    out = k2.conv2d_wu(**args)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    exp = k2.conv2d_wu_plain(**args)
    assert out.shape == exp.shape and out.device == exp.device
    assert _rel_err(out, exp) <= 1e-5
    again = k2.conv2d_wu(**args)           # a fixed summation order
    assert torch.equal(out, again)


def test_wu_plan_extremes_run(cuda):
    one = _wu_args(WU_CASES[4], cuda)
    assert k2.plan(n=1, p=4, q=4, c=8, k=8, r=1, s=1).splits == 1
    assert _rel_err(k2.conv2d_wu(**one), k2.conv2d_wu_plain(**one)) <= 1e-5
    assert k2.plan(n=32, p=56, q=56, c=64, k=64, r=1, s=1).splits > 200


def test_wu_kernel_rejects_what_it_does_not_take(cuda):
    args = _wu_args(WU_CASES[1], cuda)
    with pytest.raises(ValueError, match="float32"):
        k2.conv2d_wu(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        k2.conv2d_wu(**{**args, "do": args["do"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k2.conv2d_wu(**{**args, "do": args["do"].cpu()})


# h, c, k, r, stride, pad: the scenarios of tests/test_duality.py
TRAIN_CASES = [(8, 8, 16, 3, 1, 1), (8, 8, 8, 1, 2, 0), (16, 8, 8, 3, 2, 1),
               (9, 8, 8, 3, 2, 1), (11, 8, 8, 5, 3, 2), (24, 8, 16, 7, 2, 3),
               (13, 24, 40, 3, 2, 1)]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_conv2d_train_grads_match_ref(cuda, case):
    """dI by duality through K1 and dW through K2, against autograd of the
    cuDNN oracle with TF32 off: max |diff| <= 1e-4 * max |ref|."""
    h, c, k, r, stride, pad = case
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, h, h, c), generator=g, device=cuda)
    w = torch.randn((r, r, c, k), generator=g, device=cuda) * 0.1
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    b1, b2 = k1.launches, k2.launches
    torch.sin(conv2d_train(xk, wk, stride, pad)).sum().backward()
    torch.cuda.synchronize()
    assert k1.launches > b1 and k2.launches == b2 + 1
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.sin(ref.conv2d(xr, wr, stride=stride, padding=pad)).sum().backward()
    assert _rel_err(xk.grad, xr.grad) <= 1e-4
    assert _rel_err(wk.grad, wr.grad) <= 1e-4
