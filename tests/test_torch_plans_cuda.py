"""Every candidate plan the tuner may time, on the card, against the
kernel's plain version: K1's ``MmaPlan`` ("fwd", "bwd"), K2's ``WuPlan``
("wu") and K3's ``RingPlan`` ("q8") on a sample of ResNet-50 and
Inception-v3 signatures at the batches the port serves (16) and trains
(32).  Tuning launches plans no default ever ran; this is what makes them
safe.  Limits of ``PERF.md`` §2: K1 and K2 max |diff| <= 1e-5 * max
|plain|, K3 the same bits.

These need an NVIDIA GPU with ``nvcc``; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_plans_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import duality
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.tune import space

pytestmark = pytest.mark.gpu

# (h, w, c, k, r, stride, padding): ResNet-50 at 224x224, Inception-v3 at
# 299x299 (its 150x150 stem convs, the 5x5 branch of its mixed blocks)
RESNET = [(56, 56, 64, 64, 3, 1, 1), (56, 56, 64, 256, 1, 1, 0),
          (28, 28, 128, 128, 3, 1, 1), (14, 14, 256, 256, 3, 1, 1),
          (14, 14, 1024, 256, 1, 1, 0), (7, 7, 512, 512, 3, 1, 1),
          (7, 7, 2048, 512, 1, 1, 0), (56, 56, 128, 128, 3, 2, 1)]
INCEPTION = [(150, 150, 32, 64, 3, 1, 1), (75, 75, 48, 64, 5, 1, 2),
             (75, 75, 64, 96, 3, 1, 1), (75, 75, 256, 32, 1, 1, 0)]
SIGS = RESNET + INCEPTION
SERVE_BATCH, TRAIN_BATCH = 16, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _shape(sig):
    h, w, c, k, r, stride, padding = sig
    return dict(h=h, w=w, c=c, k=k, r=r, s=r, stride=stride,
                padding=padding)


def _rel_err(out, exp):
    return float((out - exp).abs().max()) / float(exp.abs().max())


def _k1_every_plan(dev, kind, shape, n):
    g = torch.Generator(device=dev).manual_seed(0)
    h, w, c, k, r, s = (shape[f] for f in ("h", "w", "c", "k", "r", "s"))
    x = torch.randn((n, h, w, c), generator=g, device=dev)
    wt = torch.randn((r, s, c, k), generator=g, device=dev) \
        / math.sqrt(r * s * c)
    conv = dict(stride=shape["stride"], padding=shape["padding"])
    exp = k1.conv2d_direct_plain(x, wt, **conv)
    plans = space.plan_candidates(kind, **shape, minibatch=n)
    before = k1.launches_mma
    for plan in plans:
        out = k1.conv2d_direct(x, wt, plan=plan, **conv)
        torch.cuda.synchronize()
        assert _rel_err(out, exp) <= 1e-5, (shape, plan)
    assert k1.launches_mma == before + len(plans)
    return len(plans)


@pytest.mark.parametrize("sig", SIGS)
def test_k1_every_fwd_plan_matches_plain(cuda, sig):
    assert _k1_every_plan(cuda, "fwd", _shape(sig), SERVE_BATCH) > 1


@pytest.mark.parametrize("sig", [s for s in SIGS if s[4] > 1])
def test_k1_every_bwd_plan_matches_plain(cuda, sig):
    """The dual convs one training step launches for the layer (stride-2
    layers: the phase sub-filters)."""
    sh = _shape(sig)
    duals = duality.dual_conv_signatures(
        r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"], stride=sh["stride"],
        padding=sh["padding"], input_hw=(sh["h"], sh["w"]))
    for dual in duals:
        _k1_every_plan(cuda, "bwd", dual, TRAIN_BATCH)


@pytest.mark.parametrize("sig", SIGS)
def test_k2_every_plan_matches_plain(cuda, sig):
    shape = _shape(sig)
    n = TRAIN_BATCH if sig in RESNET else SERVE_BATCH
    g = torch.Generator(device=cuda).manual_seed(2)
    h, w, c, k, r = sig[:5]
    p = space.out_dim(h, r, shape["stride"], shape["padding"])
    q = space.out_dim(w, r, shape["stride"], shape["padding"])
    args = dict(x=torch.randn((n, h, w, c), generator=g, device=cuda),
                do=torch.randn((n, p, q, k), generator=g, device=cuda),
                stride=shape["stride"], padding=shape["padding"],
                filter_rs=(r, r))
    exp = k2.conv2d_wu_plain(**args)
    plans = space.plan_candidates("wu", **shape, minibatch=n)
    assert len(plans) > 1
    before = k2.launches_mma
    for plan in plans:
        out = k2.conv2d_wu(**args, plan=plan)
        torch.cuda.synchronize()
        assert _rel_err(out, exp) <= 1e-5, (sig, plan)
    assert k2.launches_mma == before + len(plans)


@pytest.mark.parametrize("sig", SIGS)
def test_k3_every_plan_matches_plain_bit_for_bit(cuda, sig):
    """With BN, residual and ReLU in the epilogue; every split shares the
    ring's scratch, which grows to the largest plan, and the counters
    reset (a second launch of the same plan gives the same bits)."""
    shape = _shape(sig)
    g = torch.Generator(device=cuda).manual_seed(3)
    h, w, c, k, r = sig[:5]
    n = SERVE_BATCH
    p = space.out_dim(h, r, shape["stride"], shape["padding"])
    q = space.out_dim(w, r, shape["stride"], shape["padding"])
    x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(
        torch.randn((n, h, w, c), generator=g, device=cuda),
        torch.randn((r, r, c, k), generator=g, device=cuda))
    args = dict(x_q=x_q, w_q=w_q, x_scale=x_scale, w_scale=w_scale,
                stride=shape["stride"], padding=shape["padding"],
                scale=torch.rand(k, generator=g, device=cuda) + 0.5,
                shift=torch.randn(k, generator=g, device=cuda),
                residual=torch.randn((n, p, q, k), generator=g, device=cuda),
                relu=True)
    exp = k3.conv2d_q8_plain(**args)
    plans = space.plan_candidates("q8", **shape, minibatch=n)
    assert len(plans) > 1
    before = k3.launches_ring
    for plan in plans:
        out = k3.conv2d_q8(**args, plan=plan)
        again = k3.conv2d_q8(**args, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(out, exp), (sig, plan,
                                       float((out - exp).abs().max()))
        assert torch.equal(again, exp), (sig, plan)
    assert k3.launches_ring == before + 2 * len(plans)


def test_plans_refused_on_the_card(cuda):
    """A plan the route cannot run raises before any launch; a call on the
    SIMT or "sync" route takes none."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 9, 9, 8), generator=g, device=cuda)
    w = torch.randn((3, 3, 8, 16), generator=g, device=cuda)
    plan = k1.mma_plan(n=2, p=9, q=9, c=8, k=16, r=3, s=3)
    before = k1.launches
    with pytest.raises(ValueError, match="chunks"):
        k1.conv2d_direct(x, w, padding=1,
                         plan=k1.MmaPlan(plan.tile, plan.splits, 1,
                                         plan.blocks))
    ragged = torch.randn((2, 9, 9, 6), generator=g, device=cuda)
    with pytest.raises(ValueError, match="simt"):
        k1.conv2d_direct(ragged, torch.randn((3, 3, 6, 16), generator=g,
                                             device=cuda),
                         padding=1, plan=plan)
    assert k1.launches == before
