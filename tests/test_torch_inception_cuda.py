"""Inception-v3 on the card at 299x299 against the port's CPU path (the
plain versions): the f32 and int8 forwards and one SGD step, with the
tiled kernels (K1, K2, K3) and with the whole-plane ones (K10a, K10b,
K10c), within the limits of ``PERF.md`` §2, and every lane-aligned launch
on the tensor-core route by the kernels' counters.  Its 5x5 convs (C 48),
concat joins and 150x150 and 75x75 planes (C 32 and 64) run here.

These need an NVIDIA GPU with ``nvcc``; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_inception_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.backend import use_conv_tiling
from repro_torch.core.conv import lane_ok
from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.graph import GxM, executor, inception_v3
from repro_torch.graph.serving import CnnInferenceEngine
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.train.step import to_device

pytestmark = pytest.mark.gpu

IMAGE, BATCH, LR = 299, 2, 0.1
LOGIT_REL_TOL, INT8_LOGIT_REL_TOL = 1e-4, 1e-3
LOSS_REL_TOL, UPDATE_REL_TOL, PINNED_SHARE_TOL = 1e-4, 1e-3, 1e-5
TILINGS = ("tiled", "whole")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _lane_convs(gxm):
    return sum(1 for t in gxm.etg.tasks if t.op == "conv"
               and lane_ok(t.attrs["c"], t.attrs["k"]))


def _params(gxm, seed):
    """Random params with random BN statistics, so the folded epilogue is
    not the identity."""
    gen = torch.Generator().manual_seed(seed)
    params = gxm.init(gen)
    for p in params.values():
        if "var" in p:
            k, dev = p["var"].shape[0], p["var"].device
            p["mean"] = (torch.randn(k, generator=gen) * 0.1).to(dev)
            p["var"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
            p["scale"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
            p["shift"] = (torch.randn(k, generator=gen) * 0.1).to(dev)
    return params


def _to_cpu(params):
    return {name: {leaf: v.cpu() for leaf, v in p.items()}
            for name, p in params.items()}


def _images(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)


def _reset():
    k1.launches = k1.launches_mma = k1.launches_whole = 0
    k1.launches_whole_mma = 0
    k3.launches = k3.launches_ring = k3.launches_whole = 0
    k3.launches_whole_mma = 0
    k2.launches = k2.launches_mma = k2.launches_whole = 0


def _close(card, cpu, tol):
    max_abs = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    assert max_abs <= tol * scale, (max_abs, scale)
    assert torch.equal(card.argmax(-1), cpu.argmax(-1))


@pytest.mark.parametrize("tiling", TILINGS)
def test_f32_forward_matches_the_cpu(cuda, tiling):
    on_card = GxM(inception_v3(), device=cuda)
    params = _params(on_card, 0)
    images = _images()
    per_fwd = _lane_convs(on_card)
    assert per_fwd == 23
    with use_conv_tiling(tiling):
        _reset()
        card = on_card.infer(params, torch.as_tensor(images, device=cuda))
        torch.cuda.synchronize()
        counts = (k1.launches, k1.launches_mma, k1.launches_whole,
                  k1.launches_whole_mma)
        cpu = GxM(inception_v3(), device="cpu").infer(
            _to_cpu(params), torch.from_numpy(images))
    assert card.shape == (BATCH, 1000) and bool(torch.isfinite(card).all())
    want = (per_fwd, per_fwd, 0, 0) if tiling == "tiled" \
        else (0, 0, per_fwd, per_fwd)
    assert counts == want
    _close(card.cpu(), cpu, LOGIT_REL_TOL)


@pytest.mark.parametrize("tiling", TILINGS)
def test_int8_forward_matches_the_cpu(cuda, tiling):
    """One quantized params tree, calibrated on the card, served on both."""
    on_card = GxM(inception_v3(), device=cuda)
    engine = CnnInferenceEngine(on_card, _params(on_card, 0),
                                image_hw=(IMAGE, IMAGE), buckets=(BATCH,),
                                quantized=True, autotune="off")
    engine.calibrate()
    images = _images()
    per_fwd = _lane_convs(on_card)
    with use_conv_tiling(tiling):
        _reset()
        card = engine.infer(images)
        torch.cuda.synchronize()
        counts = (k3.launches, k3.launches_ring, k3.launches_whole,
                  k3.launches_whole_mma, k1.launches + k1.launches_whole)
        cpu = GxM(inception_v3(), device="cpu", quantized=True).infer(
            _to_cpu(engine.qparams), torch.from_numpy(images))
    assert bool(torch.isfinite(card).all())
    want = (per_fwd, per_fwd, 0, 0, 0) if tiling == "tiled" \
        else (0, 0, per_fwd, per_fwd, 0)
    assert counts == want
    _close(card.cpu(), cpu, INT8_LOGIT_REL_TOL)


def _pinned_step(device, tiling):
    """One SGD step on the card and on the CPU from the same params and
    batch; the CPU takes the card's ReLU masks (both ways: forward x > 0,
    backward x >= 0) and max-pool choices.  Returns the two steps, the
    decisions the CPU would have taken otherwise, and the launch counts of
    the card's step."""
    on_card = GxM(inception_v3(), device=device)
    params = on_card.init(torch.Generator().manual_seed(8))
    batch = SyntheticImageData(hw=IMAGE, n_classes=1000, global_batch=BATCH,
                               seed=8).batch_at(0)
    masks, pools = [], []
    relu, maxpool = executor._relu, executor._maxpool

    def record_relu(x):
        masks.append(((x > 0).cpu(), (x >= 0).cpu()))
        return relu(x)

    def record_pool(x, window, stride, padding):
        y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                              padding, return_indices=True)
        pools.append(idx.cpu())
        return y.permute(0, 2, 3, 1).contiguous()

    flips = dict(relu=0, relu_values=0, pool=0, pool_windows=0)
    replay_m, replay_p = iter(masks), iter(pools)

    def pinned_relu(x):
        m, g = next(replay_m)
        flips["relu"] += int(((m != (x > 0)) | (g != (x >= 0))).sum())
        flips["relu_values"] += m.numel()
        return x * m + (x - x.detach()) * (g.to(x.dtype) - m.to(x.dtype))

    def pinned_pool(x, window, stride, padding):
        idx = next(replay_p)
        xn = x.permute(0, 3, 1, 2)
        _, own = F.max_pool2d(xn, window, stride, padding,
                              return_indices=True)
        flips["pool"] += int((own != idx).sum())
        flips["pool_windows"] += idx.numel()
        y = xn.reshape(*xn.shape[:2], -1).gather(
            2, idx.reshape(*idx.shape[:2], -1)).reshape(idx.shape)
        return y.permute(0, 2, 3, 1).contiguous()

    cpu_params = _to_cpu(params)
    try:
        executor._relu, executor._maxpool = record_relu, record_pool
        with use_conv_tiling(tiling):
            _reset()
            card = on_card.sgd_train_step(params, to_device(batch, device),
                                          LR)
            torch.cuda.synchronize()
            counts = dict(k1=k1.launches, k1_mma=k1.launches_mma,
                          k2=k2.launches, k2_mma=k2.launches_mma,
                          k10a=k1.launches_whole,
                          k10a_mma=k1.launches_whole_mma,
                          k10b=k2.launches_whole)
            executor._relu, executor._maxpool = pinned_relu, pinned_pool
            cpu = GxM(inception_v3(), device="cpu").sgd_train_step(
                cpu_params, to_device(batch, "cpu"), LR)
    finally:
        executor._relu, executor._maxpool = relu, maxpool
    return cpu_params, card, cpu, flips, counts, _lane_convs(on_card)


@pytest.mark.parametrize("tiling", TILINGS)
def test_training_step_matches_the_cpu(cuda, tiling):
    old, (new_card, loss_card), (new_cpu, loss_cpu), flips, counts, convs = \
        _pinned_step(cuda, tiling)
    assert flips["relu"] <= PINNED_SHARE_TOL * flips["relu_values"]
    assert flips["pool"] <= PINNED_SHARE_TOL * flips["pool_windows"]
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    assert loss_rel <= LOSS_REL_TOL, loss_rel
    for name, p in old.items():
        for leaf, v in p.items():
            if leaf in executor.RUNNING_STATS:
                card = new_card[name][leaf].cpu() - v
                cpu = new_cpu[name][leaf] - v
            else:
                card = (v - new_card[name][leaf].cpu()) / LR
                cpu = (v - new_cpu[name][leaf]) / LR
            err = float((card - cpu).abs().max())
            assert err <= UPDATE_REL_TOL * float(cpu.abs().max()), \
                (name, leaf, err)
    # every lane-aligned conv: one forward, its dual convs, one dW
    if tiling == "tiled":
        assert counts["k1"] == counts["k1_mma"] > convs
        assert counts["k2"] == counts["k2_mma"] == convs
        assert counts["k10a"] == counts["k10b"] == 0
    else:
        assert counts["k10a"] == counts["k10a_mma"] > convs
        assert counts["k10b"] == convs
        assert counts["k1"] == counts["k2"] == 0
