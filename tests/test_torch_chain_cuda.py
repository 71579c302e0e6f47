"""Depth-first chains on the card: fused equals unfused bit for bit at
ResNet-50's bottleneck shapes (batch 2), under both conv tilings, with
every band launch on the tensor-core route by the kernels' counters, and
a stored "fwd_whole" blocking taken by both paths.

These need an NVIDIA GPU with ``nvcc``; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_chain_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core import conv as core_conv
from repro_torch.core.blocking import ConvBlocking
from repro_torch.core.conv import conv2d_chain_fwd, conv2d_fwd
from repro_torch.kernels import conv2d_direct as k1

pytestmark = pytest.mark.gpu

BATCH = 2
# (plane, C in, mid, C out, stride of the 3x3): ResNet-50 bottlenecks s0b0,
# s1b0 (the strided 3x3), s2b1 and s3b1 (the 7x7 plane)
BOTTLENECKS = [(56, 64, 64, 256, 1), (56, 256, 128, 512, 2),
               (14, 1024, 256, 1024, 1), (7, 2048, 512, 2048, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return be.resolve_device("cuda")


def _bottleneck(plane, c, mid, k, stride, device, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(device)

    def layer(ci, co, r, st):
        return dict(w=t(r, r, ci, co, scale=(2.0 / (r * r * ci)) ** 0.5),
                    stride=st, padding=r // 2, relu=True,
                    scale=t(co, scale=0.2, shift=1.0),
                    shift=t(co, scale=0.1))
    layers = [layer(c, mid, 1, 1), layer(mid, mid, 3, stride),
              layer(mid, k, 1, 1)]
    p = (plane + 2 - 3) // stride + 1
    layers[-1]["residual"] = t(BATCH, p, p, k)
    return t(BATCH, plane, plane, c), layers


def _unfused(x, layers):
    for L in layers:
        x = conv2d_fwd(x, L["w"], stride=L["stride"], padding=L["padding"],
                       scale=L["scale"], shift=L["shift"],
                       residual=L.get("residual"), relu=True)
    return x


def _counts():
    return (k1.launches, k1.launches_mma, k1.launches_whole,
            k1.launches_whole_mma)


@pytest.mark.parametrize("tiling", ("tiled", "whole"))
@pytest.mark.parametrize("geo", BOTTLENECKS)
def test_fused_equals_unfused_bit_for_bit(cuda, geo, tiling):
    x, layers = _bottleneck(*geo, device=cuda)
    p = (geo[0] + 2 - 3) // geo[4] + 1
    with be.use_conv_tiling(tiling), be.use_autotune("off"):
        want = _unfused(x, layers)
        for rb in sorted({1, 3, 7, p}):
            k1.launches = k1.launches_mma = 0
            k1.launches_whole = k1.launches_whole_mma = 0
            got = conv2d_chain_fwd(x, layers, rb=rb)
            torch.cuda.synchronize()
            n, n_mma, n_whole, n_whole_mma = _counts()
            bands = -(-p // rb)
            if tiling == "tiled":
                assert (n, n_mma, n_whole) == (3 * bands, 3 * bands, 0)
            else:
                assert (n, n_whole, n_whole_mma) == (0, 3 * bands, 3 * bands)
            assert torch.equal(got, want), (geo, tiling, rb, float(
                (got - want).abs().max()))


def test_a_stored_whole_blocking_is_taken_by_both_paths(cuda, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "chain.json"))
    cache = tune.default_cache()
    plane, c, mid, k, stride = BOTTLENECKS[0]
    x, layers = _bottleneck(plane, c, mid, k, stride, device=cuda, seed=1)
    stored = []
    for L, ci in zip(layers, (c, mid, mid)):
        r, co = L["w"].shape[0], L["w"].shape[3]
        blk = ConvBlocking(rb_p=5, k_blk=32, c_blk=ci, order="nkpc",
                           vmem_bytes=1, rb_q=0)
        cache.store(tune.conv_key(kind="fwd_whole", h=plane, w=plane, c=ci,
                                  k=co, r=r, s=r, stride=1,
                                  padding=r // 2, dtype_bytes=4,
                                  backend="cuda", minibatch=BATCH),
                    dataclasses.asdict(blk), source="model", score_us=1.0)
        stored.append((5, 32))
    seen, orig = [], k1.conv2d_direct_whole

    def spy(xb, w, *, rb_p, k_blk, **kw):
        seen.append((rb_p, k_blk))
        return orig(xb, w, rb_p=rb_p, k_blk=k_blk, **kw)
    monkeypatch.setattr(k1, "conv2d_direct_whole", spy)
    monkeypatch.setattr(core_conv, "conv2d_direct_whole", spy)
    with be.use_conv_tiling("whole"), be.use_autotune("cache"):
        want = _unfused(x, layers)
        assert seen == stored
        seen.clear()
        got = conv2d_chain_fwd(x, layers, rb=14)
    assert seen == stored * 4
    assert torch.equal(got, want)
