"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU with the CUDA toolkit (``nvcc``): a CUDA kernel has
no CPU mode, so elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import conv2d_direct as k1

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
